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
  ``scale`` (the port's ``weight``); a RoPE model has no ``pos_emb``;
- a MoE block's ``moe_mlp/{gate,wi,wo}`` (``[D, E]``, ``[E, D, F]``,
  ``[E, F, D]``) are parameters of the same names and layouts.

``params_to_flax`` is its exact inverse (the same names, the layouts
transposed back, the keys sorted as a JAX host tree has them). Both take
the ``--shard-vocab`` tables as JAX pads them (rows to a multiple of the
model axis), shapes being carried over as they are; ``shards_from_flax``
gives a tensor- or expert-parallel model's part of a flax tree
(``parallel/sharding.py``), and ``state_from_flax`` keeps only that part
of each array when it loads into such a model's state.
``flax_layout`` gives each parameter's flax path and its maps to and
from the flax leaf's layout (Adafactor keeps its statistics there).

``state_to_flax`` and ``state_from_flax`` map the port's ``TrainState``
to and from the dict that ``flax.serialization.to_state_dict`` makes of
the JAX ``TrainState``: ``step`` (int32), ``params``, ``opt_state``,
``extra`` (``{}``, or a ResNet's ``batch_stats``), ``ema`` (a param tree or None). ``opt_state`` nests
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

A ``pipelined_lm`` (``models/pipelined.py``) holds ``gpt_lm``'s names
(``layer_g`` for its layers); JAX's tree for it is ``{"shell":
{tok_emb, pos_emb, ln_f, lm_head}, "blocks": <one block's tree, each
leaf stacked [S, lps, ...] or [S, V, lps, ...]>}``.
``layers_to_pipelined`` stacks a ``gpt_lm``-shaped flax tree into it
(``parallel/pipeline.stack_stage_params``) and ``pipelined_to_layers``
unstacks it, refusing a tree of another stage count (JAX's restore
cannot restack either, and its elastic restart keeps every non-data axis);
``params_to_flax``, ``state_to_flax`` and ``state_from_flax`` go through
them for a pipelined model, which loads only its own stages' layers.

Local SGD's state (``train/local_sgd.py``) is JAX's replica-stacked
``TrainState``: ``stack_trees`` stacks every replica's tree on a
leading [R] dim (step, params and optimizer leaves) and
``stacked_state_from_flax`` loads replica r's slice into each replica
this process holds; either layout loaded into the other is refused
naming ``--param-sync-every``.

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

from tensorflow_distributed_tpu_torch.models.moe import MoeMlp
from tensorflow_distributed_tpu_torch.models.resnet import BatchNorm
from tensorflow_distributed_tpu_torch.models.transformer import (
    KVCache, RMSNorm, SelfAttention, kv_heads)
from tensorflow_distributed_tpu_torch.parallel.sharding import (
    is_split, shard_state_dict)
from tensorflow_distributed_tpu_torch.train.state import (
    TrainState, ema_init, model_extra)


def _walk(tree: Mapping[str, Any], prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _walk(value, path)
        else:
            yield path, np.asarray(value)


def _is_conv(module: str, leaf: np.ndarray) -> bool:
    """A flax Conv kernel (HWIO): the CNN's and ResNet's ``conv*`` and
    the ResNet shortcut's 1x1 ``proj`` (a 4-D attention kernel is
    ``qkv``)."""
    return leaf.ndim == 4 and (module.startswith("conv") or module == "proj")


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """flax param tree (numpy leaves) -> the port's state dict (f32 CPU
    tensors)."""
    out = {}
    for path, leaf in _walk(tree):
        *module, name = path
        if module and module[-1] == "moe_mlp":
            out[".".join(path)] = torch.tensor(np.asarray(leaf,
                                                          dtype=np.float32))
            continue
        if name == "kernel" and _is_conv(module[-1], leaf):
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


def _pipelined(model: Optional[nn.Module]) -> bool:
    return getattr(model, "is_pipelined", False)


class _Placeholder:
    """Adafactor's (1,) placeholder of a stacked leaf: optax keeps one
    for the whole leaf where the port keeps one a layer."""

    def __init__(self, value):
        self.value = value


def _is_placeholder(leaf) -> bool:
    return tuple(np.shape(leaf)) == (1,)


def layers_to_pipelined(tree: Mapping[str, Any], stages: int,
                        virtual: int = 1,
                        placeholders: bool = False) -> Dict[str, Any]:
    """A ``gpt_lm``-shaped flax tree (``layer_g`` subtrees beside the
    shell's) -> JAX's pipelined tree, each block leaf stacked over the
    layers and cut into [S, lps, ...] or [S, V, lps, ...]. With
    ``placeholders`` (Adafactor's statistics) a leaf that is (1,) in
    every layer stays one (1,) leaf."""
    from tensorflow_distributed_tpu_torch.parallel.pipeline import (
        stack_stage_params)

    n = sum(1 for k in tree if k.startswith("layer_"))
    layers = [tree[f"layer_{g}"] for g in range(n)]

    def stack(*leaves):
        if isinstance(leaves[0], Mapping):
            return {k: stack(*[lf[k] for lf in leaves])
                    for k in leaves[0]}
        if placeholders and all(_is_placeholder(lf) for lf in leaves):
            return _Placeholder(np.asarray(leaves[0]))
        return stack_stage_params(np.stack([np.asarray(lf)
                                            for lf in leaves]),
                                  stages, virtual)

    def unwrap(node):
        if isinstance(node, Mapping):
            return {k: unwrap(v) for k, v in node.items()}
        return node.value if isinstance(node, _Placeholder) else node

    shell = {k: v for k, v in tree.items() if not k.startswith("layer_")}
    return _sorted({"shell": dict(shell),
                    "blocks": unwrap(stack(*layers))})


def pipelined_to_layers(tree: Mapping[str, Any], stages: int,
                        virtual: int = 1,
                        placeholders: bool = False) -> Dict[str, Any]:
    """The inverse of ``layers_to_pipelined`` (``placeholders``: a (1,)
    block leaf goes to every layer). A tree cut into another number of
    stages (or chunks) is refused."""
    from tensorflow_distributed_tpu_torch.parallel.pipeline import (
        unstack_stage_params)

    lead = 2 if virtual == 1 else 3
    kept = {}
    if placeholders:
        kept = {path: leaf for path, leaf in _walk(tree["blocks"])
                if _is_placeholder(leaf)}
    for path, leaf in _walk(tree["blocks"]):
        if path in kept:
            continue
        got = tuple(leaf.shape[:lead - 1])
        want = (stages,) if virtual == 1 else (stages, virtual)
        if got != want:
            raise ValueError(
                f"checkpoint pipeline blocks are stacked for {got} "
                f"stages (x chunks), this mesh runs {want} at "
                f"{'/'.join(path)}; a pipelined checkpoint restores onto "
                f"its own stage count only (the JAX package cannot restack "
                f"it either: an elastic restart keeps every non-data "
                f"axis, --mesh.pipe included)")
    def unstack(node, path=()):
        if isinstance(node, Mapping):
            return {k: unstack(v, path + (str(k),)) for k, v in node.items()}
        if path in kept:
            return _Placeholder(np.asarray(node))
        return unstack_stage_params(np.asarray(node), virtual)

    flat = unstack(tree["blocks"])
    n = next(leaf.shape[0] for _, leaf in _flat_leaves(flat))

    def layer(g):
        return _tree_map_np(lambda a: a.value if isinstance(
            a, _Placeholder) else a[g], flat)

    out = dict(tree["shell"])
    out.update({f"layer_{g}": layer(g) for g in range(n)})
    return out


def _flat_leaves(tree, prefix=()):
    """(path, leaf) pairs of a tree whose leaves may be placeholders,
    the placeholders left out."""
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flat_leaves(value, prefix + (key,))
        elif not isinstance(value, _Placeholder):
            yield "/".join(prefix + (key,)), value


def _tree_map_np(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map_np(fn, v) for k, v in tree.items()}
    return fn(tree)


def shards_from_flax(tree: Mapping[str, Any], model: nn.Module
                     ) -> Dict[str, torch.Tensor]:
    """A flax param tree (or a moment or EMA of one) -> the state dict of
    the tensor- or expert-parallel ``model``'s ranks in this process
    (the whole tensors where the model has no ``tp`` or ``ep``; a
    pipelined model's own stages' layers and the shell)."""
    if _pipelined(model):
        full = params_from_flax(pipelined_to_layers(
            tree, model.num_stages, model.virtual_stages))
        names = set(dict(model.named_parameters()))
        full = {n: t for n, t in full.items() if n in names}
    else:
        full = params_from_flax(tree)
    if not is_split(model):
        return full
    return shard_state_dict(full, model)


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
    if isinstance(module, MoeMlp):
        return path + [kind], same, same
    if isinstance(module, RMSNorm):
        return path + ["scale"], same, same
    if isinstance(module, BatchNorm):
        return path + ["scale" if kind == "weight" else "bias"], same, same
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
    ``params_from_flax``. ``model`` says which module each name is; a
    pipelined model's (every layer of it) gives JAX's pipelined tree."""
    tree = _nest(_flax_leaf(model, name, t) for name, t in params.items())
    if _pipelined(model):
        return layers_to_pipelined(tree, model.num_stages,
                                   model.virtual_stages)
    return tree


def _stats_to_flax(stats: Mapping[str, torch.Tensor], model: nn.Module
                   ) -> Dict[str, Any]:
    """Per-parameter tensors already in the flax layout (Adafactor's
    statistics) -> the param tree's paths (a pipelined model's stacked,
    one placeholder a stacked leaf)."""
    tree = _nest((flax_layout(model, name)[0], t)
                 for name, t in stats.items())
    if _pipelined(model):
        return layers_to_pipelined(tree, model.num_stages,
                                   model.virtual_stages, placeholders=True)
    return tree


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


def extra_to_flax(model: nn.Module) -> Dict[str, Any]:
    """The model's non-param collections as the JAX ``TrainState.extra``:
    ``{"batch_stats": {<BN path>: {"mean", "var"}}}`` for a model with
    BatchNorm, ``{}`` otherwise."""
    stats = [(name.split("."), t) for name, t in model_extra(model).items()]
    return {"batch_stats": _nest(stats)} if stats else {}


@torch.no_grad()
def extra_from_flax(tree: Mapping[str, Any], model: nn.Module) -> None:
    """Load a JAX ``extra`` (``batch_stats``) into the model's BN buffers
    in place, after checking names and shapes; pending statistics of an
    unfinished step are dropped."""
    dst = model_extra(model)
    src = {".".join(path): torch.from_numpy(leaf.astype(np.float32))
           for path, leaf in _walk(tree.get("batch_stats", {}))}
    _check_names(src, dst, "batch_stats")
    for name, t in dst.items():
        _copy_checked(t, src[name], f"batch_stats {name}")
    if dst:
        model.commit_batch_stats(keep=False)


def state_to_flax(state: TrainState) -> Dict[str, Any]:
    """The port's train state -> the JAX ``TrainState``'s state dict
    (numpy leaves on the host), in the JAX field and key order."""
    def convert(tensors):
        return params_to_flax(tensors, state.model)

    return {"step": np.asarray(state.step, np.int32),
            "params": convert(state.params),
            "opt_state": _opt_to_flax(state, convert),
            "extra": extra_to_flax(state.model),
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
          what: str, model: Optional[nn.Module] = None,
          cut: Optional[Callable] = None) -> None:
    """Copy a flax param tree into the port's tensors of the same names
    (``model``'s shards of it under tensor parallelism, and ``cut`` of
    those: a data partition's blocks), in place, after checking names
    and shapes."""
    src = shards_from_flax(tree, model)
    if cut is not None:
        src = cut(src)
    _check_names(src, dst, what)
    for name, t in dst.items():
        _copy_checked(t, src[name], f"{what} {name}")


@torch.no_grad()
def _load_stats(dst: Dict[str, torch.Tensor], tree: Mapping[str, Any],
                model: nn.Module, what: str) -> None:
    """Copy flax-layout statistics (Adafactor's) from the param tree's
    paths into the port's tensors, in place, after checking names and
    shapes (a pipelined model's: unstacked, its own layers')."""
    paths = {name: "/".join(flax_layout(model, name)[0]) for name in dst}
    if _pipelined(model):
        tree = pipelined_to_layers(tree, model.num_stages,
                                   model.virtual_stages, placeholders=True)
    src = {"/".join(path): leaf for path, leaf in _walk(tree)}
    if _pipelined(model):
        src = {p: leaf for p, leaf in src.items() if p in set(
            paths.values())}
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
    the decay mask across a resume restores, as JAX aligns the mask. A
    replica-stacked tree (local SGD's) is refused naming the flag."""
    if is_stacked(tree):
        raise ValueError(
            f"checkpoint leaf shape {tuple(np.shape(tree['step']))} != "
            f"template () at step; was this run saved with a different "
            f"--param-sync-every (replica-stacked vs plain state)?")
    part = state.partition
    _load(state.params, tree["params"], "params", state.model,
          part.cut_params)
    extra_from_flax(tree.get("extra") or {}, state.model)
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
            _load(state.opt_state[name], core[name], f"opt_state {name}",
                  state.model, part.cut_slots)
    if tree.get("ema") is None:
        state.ema = None
    else:
        if state.ema is None:
            state.ema = ema_init(state.params)
        _load(state.ema, tree["ema"], "ema", state.model, part.cut_params)
    state.step = int(tree["step"])
    return state


def map_tree(fn, tree):
    """``fn`` on every array leaf of a state dict (None and empty dicts
    kept)."""
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return None if tree is None else fn(np.asarray(tree))


STACKED_KEYS = ("step", "params", "opt_state")


def is_stacked(tree: Mapping[str, Any]) -> bool:
    """Whether a state dict is local SGD's replica-stacked one (a
    ``step`` of shape [R])."""
    return np.ndim(tree.get("step")) == 1


def stack_trees(trees: List[Mapping[str, Any]]) -> Dict[str, Any]:
    """Local SGD's replicas' plain state dicts (each ``state_to_flax``,
    every one of the D in data order) -> the JAX replica-stacked
    ``TrainState``'s state dict: the step, params and optimizer leaves
    (the counts too) stacked on a leading [R] dim, as JAX's
    ``stack_state`` broadcasts them; ``extra`` ``{}`` and no EMA."""
    def stack(*leaves):
        if isinstance(leaves[0], Mapping):
            return {k: stack(*[lf[k] for lf in leaves]) for k in leaves[0]}
        return np.stack([np.asarray(lf) for lf in leaves])

    out = dict(trees[0])
    for key in STACKED_KEYS:
        out[key] = stack(*[t[key] for t in trees])
    return out


def replica_from_flax(tree: Mapping[str, Any], r: int) -> Dict[str, Any]:
    """Replica ``r`` of a replica-stacked state dict, as a plain one."""
    out = dict(tree)
    for key in STACKED_KEYS:
        out[key] = map_tree(lambda a: a[r], tree[key])
    return out


def stacked_state_from_flax(tree: Mapping[str, Any],
                            states: List[TrainState], ranks: List[int],
                            replicas: int) -> List[TrainState]:
    """Load a JAX replica-stacked state dict into the replicas ``states``
    (data ranks ``ranks`` of ``replicas``) in place: replica r's slice
    of every leaf through ``state_from_flax``. A plain state dict, or
    one of another replica count, is refused naming the flag."""
    steps = tuple(np.shape(tree.get("step")))
    if steps != (replicas,):
        raise ValueError(
            f"checkpoint leaf shape {steps} != template {(replicas,)} at "
            f"step; was this run saved with a different "
            f"--param-sync-every (replica-stacked vs plain state)?")
    for r, state in zip(ranks, states):
        state_from_flax(replica_from_flax(tree, r), state)
    return states


def cache_from_flax(tree: Mapping[str, Any]) -> KVCache:
    """flax ``cache`` collection (numpy leaves) -> the port's KVCache
    (CPU tensors in the leaves' dtype): a dense cache [B, max_len, ...]
    or a paged pool [num_pages, page_size, ...] alike, with the f32
    ``key_scale`` / ``value_scale`` leaves of an int8 cache. The scalar
    ``index`` is dropped: positions are the authority on depth in both
    packages."""
    layers = sorted((k for k in tree if k.startswith("layer_")),
                    key=lambda k: int(k.split("_")[1]))
    attn = [tree[k]["attn"] for k in layers]

    def leaves(name):
        return [torch.from_numpy(np.array(a[name])) for a in attn]

    if "key_scale" not in attn[0]:
        return KVCache(k=leaves("key"), v=leaves("value"))
    return KVCache(k=leaves("key"), v=leaves("value"),
                   k_scale=leaves("key_scale"), v_scale=leaves("value_scale"))
