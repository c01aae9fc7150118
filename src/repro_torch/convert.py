"""State carried across from the JAX package, as numpy arrays.

The reference hands its state over as numpy (``np.asarray`` of every
leaf); this module turns such trees into the port's tensors and back. bf16
arrives as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` does not
take: it crosses through an ``int16`` view. Arrays that are not writable
are copied first. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def array_from_numpy(a, device=None) -> torch.Tensor:
    dev = resolve_device(device)
    a = np.asarray(a)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.ascontiguousarray(a).copy()
    if _is_bf16(a):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def array_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def tree_from_numpy(tree, device=None):
    """Nested dicts / lists of numpy arrays -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, device) for v in tree)
    return array_from_numpy(tree, device)


def tree_to_numpy(tree):
    """Inverse of :func:`tree_from_numpy`."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    return array_to_numpy(tree)


_TIERED_KEYS = ("leap", "pool_meta", "ring", "hot")


def tiered_state_from_numpy(state_np: dict, device=None) -> dict:
    """A reference tiered state (``tiered_init`` / ``tiered_sweep`` output,
    leaves numpy with the leading stream axis) as the port's state dict."""
    missing = [k for k in _TIERED_KEYS if k not in state_np]
    if missing:
        raise ValueError(f"tiered state lacks {missing}")
    return {k: tree_from_numpy(state_np[k], device) for k in _TIERED_KEYS}


def model_params_from_jax(params_np: dict, cfg, device=None):
    """The reference's ``init_params`` tree (leaves numpy) as the port's
    model of ``cfg``: a :class:`~repro_torch.models.transformer.Transformer`,
    or an :class:`~repro_torch.models.encdec.EncDec` for the ``encdec``
    family.

    The reference stacks the parameters of each position ``p`` of the
    layer pattern over periods: ``params["period"][p]`` has leaves
    ``[n_periods, ...]``, and layer ``l`` is period ``l // P`` at position
    ``l % P`` (``P = cfg.scan_period()``). Each layer's slice goes to
    ``blocks[l]`` under the same names. Orientation, as in the reference
    (``[d_in, d_out]``, applied as ``x @ w``), kept as it is:

    * ``embed [V, d]`` (``V`` = ``cfg.padded_vocab``); tied embeddings use
      its transpose as the head; else ``lm_head [d, V]``;
    * ``mix.wq [d, Hq*dh]``, ``mix.wk`` / ``mix.wv [d, Hkv*dh]``,
      ``mix.wo [Hq*dh, d]``; biases ``bq [Hq*dh]``, ``bk`` / ``bv
      [Hkv*dh]``;
    * ``ff.wg`` / ``ff.wu [d, d_ff]``, ``ff.wd [d_ff, d]``;
    * Mamba mixers: ``mix.w_in [d, 2*di]``, ``mix.conv [K, di]``,
      ``mix.w_xdbc [di, dt_rank + 2N]``, ``mix.w_dt [dt_rank, di]``,
      ``mix.w_out [di, d]``, and ``mix.dt_bias [di]``, ``mix.a_log
      [di, N]``, ``mix.d_skip [di]`` in float32;
    * MoE feed-forwards: ``ff.wr [d, E]``, ``ff.wg`` / ``ff.wu [E, d, F]``,
      ``ff.wd [E, F, d]``, and the shared expert's MLP ``ff.shared.wg`` /
      ``ff.shared.wu [d, F*n_shared]``, ``ff.shared.wd [F*n_shared, d]``;
    * mLSTM mixers: ``mix.w_up [d, 2*di]``, ``mix.w_q`` / ``mix.w_k`` /
      ``mix.w_v [H, dh, dh]``, ``mix.w_if [di, 2H]``, ``mix.w_o [di, di]``,
      ``mix.w_dn [di, d]``, ``mix.conv [K, di]``, and ``mix.f_bias`` /
      ``mix.i_bias [H]``, ``mix.skip [di]`` in float32;
    * sLSTM mixers: ``mix.w [d, 4d]``, ``mix.r [4, H, dh, dh]``,
      ``mix.w_dn [d, d]``, and ``mix.bias [4d]`` in float32;
    * ``norm1`` / ``norm2`` / ``final_norm``: ``scale [d]`` (and ``bias``
      for layernorm).

    The encoder-decoder's tree is not period-stacked: ``enc`` and ``dec``
    have leaves ``[L, ...]``, layer ``l`` going to ``enc.{l}`` / ``dec.{l}``
    (``norm1``, ``attn`` / ``self``, ``normx``, ``cross``, ``norm2``,
    ``ff``), beside ``in_proj [d, d]``, ``enc_norm``, ``embed``,
    ``final_norm`` and ``lm_head``.

    bf16 leaves cross through :func:`array_from_numpy`. Every parameter of
    the module must be filled, and every leaf used, or this raises.
    """
    from repro_torch.models.model import build_model

    model = build_model(cfg, device=device, seed=None)
    P = cfg.scan_period()
    filled = set()

    def put(name: str, leaf) -> None:
        t = model.get_parameter(name)
        a = array_from_numpy(leaf, t.device)
        if tuple(a.shape) != tuple(t.shape) or a.dtype != t.dtype:
            raise ValueError(f"{name}: reference leaf {tuple(a.shape)} "
                             f"{a.dtype} does not fit {tuple(t.shape)} "
                             f"{t.dtype}")
        with torch.no_grad():
            t.copy_(a)
        filled.add(name)

    def walk(prefix: str, tree, index=None) -> None:
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(f"{prefix}{k}.", v, index)
            else:
                put(prefix + k, v if index is None else np.asarray(v)[index])

    put("embed", params_np["embed"])
    walk("final_norm.", params_np["final_norm"])
    if "lm_head" in params_np:
        put("lm_head_w", params_np["lm_head"])
    if cfg.family == "encdec":
        put("in_proj", params_np["in_proj"])
        walk("enc_norm.", params_np["enc_norm"])
        for name, n in (("enc", cfg.n_enc_layers), ("dec", cfg.n_layers)):
            for layer in range(n):
                walk(f"{name}.{layer}.", params_np[name], layer)
    else:
        for layer in range(cfg.n_layers):
            walk(f"blocks.{layer}.", params_np["period"][layer % P],
                 layer // P)
    missing = sorted(set(dict(model.named_parameters())) - filled)
    if missing:
        raise ValueError(f"parameters not in the reference tree: {missing}")
    return model


def _ref_path(key: str) -> list:
    """A parameter-tree key as the reference tree's path: ``period.0.mix.wq``
    -> ``["period", 0, "mix", "wq"]`` (the period tuple's index an int)."""
    parts = key.split(".")
    if parts[0] == "period":
        parts[1] = int(parts[1])
    return parts


def _ref_get(tree, key: str):
    for k in _ref_path(key):
        tree = tree[k]
    return tree


def _split(key: str, a) -> list:
    """A reference leaf as the port's parts: one a period when stacked."""
    from repro_torch.optim.common import stacked
    a = np.asarray(a)
    return list(a) if stacked(key) else [a]


def _stack(key: str, parts: list) -> np.ndarray:
    from repro_torch.optim.common import stacked
    arrs = [array_to_numpy(t) for t in parts]
    return np.stack(arrs) if stacked(key) else arrs[0]


def _to_ref_tree(flat: dict) -> dict:
    """``{key: leaf}`` -> the reference's nested tree (``period`` a
    tuple of the positions' dicts)."""
    out: dict = {}
    for key, leaf in flat.items():
        *path, last = _ref_path(key)
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    if "period" in out:
        out["period"] = tuple(out["period"][i]
                              for i in range(len(out["period"])))
    return out


def train_state_from_jax(params_np: dict, opt_np: dict, cfg, opt_name: str,
                         device=None):
    """The reference's parameters and optimizer state (leaves numpy) as
    the port's trainable model of ``cfg`` and the optimizer state of
    ``repro_torch.optim`` over its parameter tree
    (``optim.common.param_tree``): AdamW's ``m`` / ``v``, split per layer
    as the parameters are; Adafactor's ``row`` / ``col`` / ``v``, which
    keep the reference's stacked shapes (its statistics couple the layers
    a leaf stacks). Returns ``(model, opt_state)``."""
    from repro_torch.optim.common import param_tree

    model = model_params_from_jax(params_np, cfg, device)
    model.requires_grad_(True)
    tree = param_tree(model)
    dev = model.device
    if opt_name == "adamw":
        state = {n: {k: [array_from_numpy(a, dev)
                         for a in _split(k, _ref_get(opt_np[n], k))]
                     for k in tree} for n in ("m", "v")}
    elif opt_name == "adafactor":
        state = {"acc": {k: {n: array_from_numpy(a, dev)
                             for n, a in _ref_get(opt_np["acc"], k).items()}
                         for k in tree}}
    else:
        raise ValueError(f"unknown optimizer {opt_name!r}")
    return model, state


def params_to_jax(model) -> dict:
    """The inverse of :func:`model_params_from_jax` for the decoder-only
    trunk: the model's parameters as the reference's tree, leaves numpy,
    period leaves stacked."""
    from repro_torch.optim.common import param_tree
    return _to_ref_tree({k: _stack(k, parts)
                         for k, parts in param_tree(model).items()})


def grads_to_jax(model, cfg, opt_state: dict | None = None):
    """The port's gradients (each parameter's ``.grad``; zeros where none)
    as the reference's gradient tree, leaves numpy, period leaves stacked;
    with ``opt_state`` also that state in the reference's optimizer tree:
    ``(grads, opt)``. ``cfg`` must be the model's."""
    from repro_torch.optim.common import param_tree

    if model.cfg != cfg:
        raise ValueError(f"model of {model.cfg.name}, not of {cfg.name}")
    tree = param_tree(model)
    grads = _to_ref_tree({
        k: _stack(k, [torch.zeros_like(p) if p.grad is None else p.grad
                      for p in parts]) for k, parts in tree.items()})
    if opt_state is None:
        return grads
    if "acc" in opt_state:
        opt = {"acc": _to_ref_tree({
            k: {n: array_to_numpy(t) for n, t in acc.items()}
            for k, acc in opt_state["acc"].items()})}
    else:
        opt = {n: _to_ref_tree({k: _stack(k, parts)
                                for k, parts in opt_state[n].items()})
               for n in ("m", "v")}
    return grads, opt
