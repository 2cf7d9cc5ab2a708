"""Weights carried across from the JAX package.

``params_from_flax`` maps the param tree that the JAX ``gpt_lm`` or
``mnist_cnn`` builds (a nested dict of numpy arrays, e.g.
``jax.device_get(state.params)``) to a state dict of the port's
``CausalLM`` or ``MnistCNN``. Names mirror each other
(``layer_0/attn/qkv/kernel`` -> ``layer_0.attn.qkv.weight``); the
kernels change layout:

- flax Dense kernels are ``[in, out]``, torch Linear weights ``[out, in]``;
- flax Conv kernels (``conv*``) are HWIO ``[5, 5, I, O]``, torch Conv2d
  weights OIHW;
- the attention ``qkv`` DenseGeneral kernel ``[D, 3, H, dh]`` (bias
  ``[3, H, dh]``), and under GQA ``q`` ``[D, H, dh]`` and ``kv``
  ``[D, 2, nk, dh]``, flatten their output axes, and ``out``
  ``[H, dh, D]`` flattens its two contracted input axes;
- the SwiGLU ``mlp/gate`` is a Dense like ``up``; an RMSNorm has only a
  ``scale`` (the port's ``weight``); a RoPE model has no ``pos_emb``.

``params_to_flax`` is its exact inverse (the same names, the layouts
transposed back, the keys sorted as a JAX host tree has them).
``flax_layout`` gives each parameter's flax path and its maps to and
from the flax leaf's layout (Adafactor keeps its statistics there).

``state_to_flax`` and ``state_from_flax`` map the port's ``TrainState``
to and from the dict that ``flax.serialization.to_state_dict`` makes of
the JAX ``TrainState``: ``step`` (int32), ``params``, ``opt_state``,
``extra`` (``{}``), ``ema`` (a param tree or None). ``opt_state`` nests
as the optax chain of ``train/optim.py`` does, each member's state a
dict keyed by its position:

- adam: ``{"0": {count, mu, nu}, "1": {count}}`` (scale_by_adam, the
  schedule); adamw adds the decay mask's ``{"inner_state": {}}`` between
  them; sgd is ``{"0": {trace}, "1": {count}}``;
- adafactor: ``{"0": {count, v_row, v_col, v}, "1": {}, "2": {count},
  "3": {}, "4": {}}`` (optax's ``FactoredState``, the block-RMS clip, the
  schedule, the param-block-RMS scale, the -1 scale); with weight decay
  the mask's ``{"inner_state": {}}`` comes before the last. Each leaf's
  statistics are in the flax leaf's layout, with ``(1,)`` placeholders
  where optax keeps them;
- with ``grad_clip_norm`` the chain is ``{"0": {}, "1": <the above>}``.

The port's moments are per-name dicts of tensors and its ``count`` one
Python int, where JAX keeps an int32 array per counting member.

``cache_from_flax`` maps the ``cache`` collection that the JAX model's
``decode=True`` path fills (``layer_i/attn/{key,value}`` of shape
``[B, max_len, nk, Dh]``, nk = H without GQA, plus a scalar ``index``)
to the port's ``KVCache``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tensorflow_distributed_tpu_torch.models.transformer import (
    KVCache, RMSNorm, SelfAttention, kv_heads)
from tensorflow_distributed_tpu_torch.train.state import TrainState, ema_init


def _walk(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _walk(value, path)
        else:
            yield path, np.asarray(value)


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> the port's state dict (f32 CPU
    tensors)."""
    out = {}
    for path, leaf in _walk(tree):
        *module, name = path
        if name == "kernel" and module[-1].startswith("conv"):
            value = leaf.transpose(3, 2, 0, 1)
        elif name == "kernel":
            # The attention's DenseGeneral "out" contracts two input
            # axes ([H, dh, D]); every other kernel contracts one.
            n_in = 2 if module[-1] == "out" and leaf.ndim == 3 else 1
            rows = int(np.prod(leaf.shape[:n_in]))
            value = leaf.reshape(rows, -1).T
        elif name in ("embedding", "scale"):
            value = leaf
        elif name == "bias":
            value = leaf.reshape(-1)
        else:
            raise ValueError(f"unknown flax leaf {'/'.join(path)}")
        key = ".".join(module + ["weight" if name != "bias" else "bias"])
        out[key] = torch.tensor(np.asarray(value, dtype=np.float32))
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        raise ValueError("a bfloat16 tensor has no numpy dtype; the "
                         "checkpoint format holds float32 params, moments "
                         "and EMA")
    return t.detach().cpu().numpy()


def _sorted(tree: dict) -> dict:
    """Keys sorted at every level, as a JAX host tree has them."""
    return {k: _sorted(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def flax_layout(model: nn.Module, name: str
                ) -> Tuple[List[str], Callable, Callable]:
    """(flax path, to_flax, from_flax) of the port parameter ``name``:
    ``to_flax`` maps a tensor of the parameter's shape (the parameter, a
    moment, its grad) to the flax leaf's layout, on its device and a
    view where one exists; ``from_flax`` is its inverse."""
    *path, kind = name.split(".")
    module = model.get_submodule(".".join(path))

    def same(t):
        return t

    if isinstance(module, nn.Embedding):
        return path + ["embedding"], same, same
    if isinstance(module, RMSNorm):
        return path + ["scale"], same, same
    if isinstance(module, nn.LayerNorm):
        return path + ["scale" if kind == "weight" else "bias"], same, same
    if isinstance(module, nn.Conv2d):
        if kind == "bias":
            return path + ["bias"], same, same
        return (path + ["kernel"], lambda t: t.permute(2, 3, 1, 0),  # HWIO
                lambda t: t.permute(3, 2, 0, 1))                      # OIHW
    if not isinstance(module, nn.Linear):
        raise ValueError(f"no flax leaf for parameter {name!r}")
    attn = model.get_submodule(".".join(path[:-1]))
    # The DenseGeneral leaves' output axes (qkv [3, H, dh], q [H, dh],
    # kv [2, nk, dh]) and out's contracted input axes [H, dh].
    heads = None
    if isinstance(attn, SelfAttention):
        cfg = attn.cfg
        h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
        heads = {"qkv": (3, h, dh), "q": (h, dh),
                 "kv": (2, kv_heads(cfg), dh), "out": (h, dh)}.get(path[-1])
    if kind == "bias":
        if heads and path[-1] != "out":
            return (path + ["bias"], lambda t: t.reshape(heads),
                    lambda t: t.reshape(-1))
        return path + ["bias"], same, same
    if heads and path[-1] == "out":
        return (path + ["kernel"], lambda t: t.t().reshape(*heads, -1),
                lambda t: t.reshape(-1, t.shape[-1]).t())
    if heads:
        return (path + ["kernel"], lambda t: t.t().reshape(-1, *heads),
                lambda t: t.reshape(t.shape[0], -1).t())
    return path + ["kernel"], lambda t: t.t(), lambda t: t.t()


def _flax_leaf(model: nn.Module, name: str, value: torch.Tensor):
    """(flax path, leaf) of the port parameter ``name``, the leaf still
    a tensor on its device (the layout change runs there)."""
    path, to_flax, _ = flax_layout(model, name)
    return path, to_flax(value)


def _nest(leaves) -> Dict[str, Any]:
    """(flax path, tensor) pairs -> a tree of numpy leaves, keys sorted."""
    tree: Dict[str, Any] = {}
    for path, leaf in leaves:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _numpy(leaf.detach().contiguous())
    return _sorted(tree)


def params_to_flax(params: Mapping[str, torch.Tensor], model: nn.Module
                   ) -> Dict[str, Any]:
    """The port's named tensors (params, or a moment or the EMA of
    them) -> the flax param tree of numpy leaves: the inverse of
    ``params_from_flax``. ``model`` says which module each name is."""
    return _nest(_flax_leaf(model, name, t) for name, t in params.items())


def _stats_to_flax(stats: Mapping[str, torch.Tensor], model: nn.Module
                   ) -> Dict[str, Any]:
    """Per-parameter tensors already in the flax layout (Adafactor's
    statistics) -> the param tree's paths."""
    return _nest((flax_layout(model, name)[0], t)
                 for name, t in stats.items())


def _opt_to_flax(state: TrainState, convert) -> Dict[str, Any]:
    tx, opt = state.tx, state.opt_state
    count = np.asarray(opt["count"], np.int32)
    if tx.kind == "sgd":
        chain = [{"trace": convert(opt["trace"])}, {"count": count}]
    elif tx.kind == "adafactor":
        stats = {k: _stats_to_flax(opt[k], state.model)
                 for k in ("v_row", "v_col", "v")}
        # FactoredState (its fields in their NamedTuple's order), then
        # clip_by_block_rms, the schedule, scale_by_param_block_rms,
        # [the masked decayed weights,] scale(-1).
        chain = [{"count": count, **stats}, {}, {"count": count}, {}]
        if tx.weight_decay:
            chain.append({"inner_state": {}})  # optax.masked's state
        chain.append({})
    else:
        chain = [{"count": count, "mu": convert(opt["mu"]),
                  "nu": convert(opt["nu"])}]
        if tx.weight_decay:
            chain.append({"inner_state": {}})  # optax.masked's state
        chain.append({"count": count})  # the schedule's
    tree = {str(i): member for i, member in enumerate(chain)}
    return {"0": {}, "1": tree} if tx.clip_norm else tree


def state_to_flax(state: TrainState) -> Dict[str, Any]:
    """The port's train state -> the JAX ``TrainState``'s state dict
    (numpy leaves on the host), in the JAX field and key order."""
    def convert(tensors):
        return params_to_flax(tensors, state.model)

    return {"step": np.asarray(state.step, np.int32),
            "params": convert(state.params),
            "opt_state": _opt_to_flax(state, convert),
            "extra": {},
            "ema": None if state.ema is None else convert(state.ema)}


def _find(tree: Any, key: str) -> Optional[dict]:
    """The first dict (depth first, in key order) that holds ``key``."""
    if not isinstance(tree, dict):
        return None
    if key in tree:
        return tree
    for value in tree.values():
        found = _find(value, key)
        if found is not None:
            return found
    return None


def _check_names(src: Mapping[str, Any], dst: Mapping[str, Any],
                 what: str) -> None:
    if set(src) != set(dst):
        raise ValueError(
            f"checkpoint {what} do not match the model: missing "
            f"{sorted(set(dst) - set(src))}, unexpected "
            f"{sorted(set(src) - set(dst))}")


def _copy_checked(dst: torch.Tensor, src: torch.Tensor, what: str) -> None:
    if src.shape != dst.shape:
        raise ValueError(
            f"{what}: checkpoint leaf shape {tuple(src.shape)} != template "
            f"{tuple(dst.shape)}; was this run saved with another model "
            f"size, --seq-len or vocabulary?")
    dst.copy_(src)


@torch.no_grad()
def _load(dst: Dict[str, torch.Tensor], tree: Mapping[str, Any],
          what: str) -> None:
    """Copy a flax param tree into the port's tensors of the same names,
    in place, after checking names and shapes."""
    src = params_from_flax(tree)
    _check_names(src, dst, what)
    for name, t in dst.items():
        _copy_checked(t, src[name], f"{what} {name}")


@torch.no_grad()
def _load_stats(dst: Dict[str, torch.Tensor], tree: Mapping[str, Any],
                model: nn.Module, what: str) -> None:
    """Copy flax-layout statistics (Adafactor's) from the param tree's
    paths into the port's tensors, in place, after checking names and
    shapes."""
    src = {"/".join(path): leaf for path, leaf in _walk(tree)}
    paths = {name: "/".join(flax_layout(model, name)[0]) for name in dst}
    _check_names(src, set(paths.values()), what)
    for name, t in dst.items():
        _copy_checked(t, torch.from_numpy(src[paths[name]].astype(
            np.float32)), f"{what} {name}")


_MOMENTS = {"sgd": ("trace",), "adam": ("mu", "nu"),
            "adafactor": ("v_row", "v_col", "v")}


def state_from_flax(tree: Mapping[str, Any], state: TrainState
                    ) -> TrainState:
    """Load a JAX ``TrainState`` state dict (numpy leaves, as
    ``msgpack_restore`` gives them) into the port's ``state`` in place:
    params, moments (Adafactor's statistics), count, step, and the EMA
    when ``tree`` has one (none: ``state.ema`` becomes None). Names and
    shapes must match the model's; the moments are found by name
    wherever the chain nests them, so adding or dropping clipping or
    the decay mask across a resume restores, as JAX aligns the mask."""
    _load(state.params, tree["params"], "params")
    tx, opt = state.tx, tree["opt_state"]
    names = _MOMENTS[tx.kind]
    core = _find(opt, names[0])
    if core is None:
        raise ValueError(
            f"the checkpoint's optimizer state has no {names[0]!r}: it was "
            f"not written by --optimizer {tx.kind}")
    counter = core if "count" in core else _find(opt, "count")
    state.opt_state["count"] = int(counter["count"])
    for name in names:
        if tx.kind == "adafactor":
            _load_stats(state.opt_state[name], core[name], state.model,
                        f"opt_state {name}")
        else:
            _load(state.opt_state[name], core[name], f"opt_state {name}")
    if tree.get("ema") is None:
        state.ema = None
    else:
        if state.ema is None:
            state.ema = ema_init(state.params)
        _load(state.ema, tree["ema"], "ema")
    state.step = int(tree["step"])
    return state


def cache_from_flax(tree: Mapping[str, Any]) -> KVCache:
    """flax ``cache`` collection (numpy leaves) -> the port's KVCache
    (CPU tensors in the leaves' dtype). The scalar ``index`` is dropped:
    positions are the authority on depth in both packages."""
    layers = sorted((k for k in tree if k.startswith("layer_")),
                    key=lambda k: int(k.split("_")[1]))
    attn = [tree[k]["attn"] for k in layers]
    return KVCache(
        k=[torch.from_numpy(np.array(a["key"])) for a in attn],
        v=[torch.from_numpy(np.array(a["value"])) for a in attn])
