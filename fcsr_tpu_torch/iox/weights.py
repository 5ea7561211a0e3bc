"""Carry GSR-Net, GAT U-Net, MLP and upsampler weights between the JAX
package and the port (GSR-Net first; the GAT U-Net's layouts, then the MLP
family's and the GraphSAGE upsampler's, are at the end of the file).

Three layouts, as plain numpy arrays (the torch boundary is
``torch.from_numpy`` on the caller's side), and for the last two also as
torch tensors under autograd (``state_to_leaf_tensors`` /
``leaf_tensors_to_state``, which the loss entry points and the unfused
trainer use):

* the JAX package's flax tree ``{"params": {"net": ..., "layer": ...}}``
  whose Dense kernels are (in, out);
* the port's ``state_dict`` names — the reference's torch names::

      layer.weights                      (hr, lr)
      net.{start,bottom,end}_gcn.proj.{weight,bias}   Linear: (out, in)
      net.{down_gcns,up_gcns,pools}.{i}.proj.{weight,bias}
      gc1.weight, gc2.weight             (in, out), no bias

* the training kernels' leaf order (``models/fused_step.py::leaf_specs``):
  15 Linear kernels as (in, out) with ``end_gcn`` split into its two
  (hr, hr) halves, then 15 biases staged (1, out), then the tail's
  ``layer.weights``, ``gc1.weight``, ``gc2.weight``; flattened leaf after
  leaf into one (P,) vector per fold.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np

__all__ = ["lin_names", "leaf_names", "flax_to_state", "state_to_flax",
           "state_to_leaves", "leaves_to_state", "leaves_to_flat",
           "flat_to_leaves", "state_to_flat", "flat_to_state",
           "state_to_leaf_tensors", "leaf_tensors_to_state", "TAIL_NAMES",
           "gat_dims", "gat_layer_specs", "gat_leaf_names",
           "gat_leaf_shapes", "gat_flax_to_state", "gat_state_to_flax",
           "gat_state_to_leaves", "gat_leaves_to_state", "gat_state_to_flat",
           "gat_flat_to_state", "gat_leaf_tensors_to_state", "mlp_entries",
           "mlp_flax_to_state", "mlp_state_to_flax", "mlp_state_to_leaves",
           "mlp_leaves_to_state", "mlp_state_to_flat", "mlp_flat_to_state",
           "upsample_flax_to_state", "upsample_state_to_flax"]

TAIL_NAMES = ("layer.weights", "gc1.weight", "gc2.weight")


def lin_names(n_levels: int) -> List[str]:
    """The U-Net's 15 Linear modules in kernel order (flax names)."""
    return (["start_gcn"]
            + [f"down_gcns_{i}" for i in range(n_levels)]
            + [f"pools_{i}" for i in range(n_levels)]
            + ["bottom_gcn"]
            + [f"up_gcns_{i}" for i in range(n_levels)]
            + ["end_gcn"])


def leaf_names(n_levels: int, tail: bool = True) -> List[str]:
    """Names of the training kernels' leaves in their order: ``w:<module>``
    for the 16 Linear kernels (``end_gcn`` as ``_a`` / ``_b`` halves),
    ``b:<module>`` for the 15 biases, then (with ``tail``) the three tail
    weights under their state_dict names."""
    names = lin_names(n_levels)
    return ([f"w:{n}" for n in names[:-1]] + ["w:end_gcn_a", "w:end_gcn_b"]
            + [f"b:{n}" for n in names] + (list(TAIL_NAMES) if tail else []))


def _torch_prefix(flax_name: str) -> str:
    """``down_gcns_3`` -> ``net.down_gcns.3.proj``."""
    head, _, tail = flax_name.rpartition("_")
    if tail.isdigit() and head in ("down_gcns", "up_gcns", "pools"):
        return f"net.{head}.{tail}.proj"
    return f"net.{flax_name}.proj"


def _n_levels(keys) -> int:
    return sum(1 for k in keys
               if k.startswith("net.down_gcns.") and k.endswith(".bias"))


def flax_to_state(params) -> Dict[str, np.ndarray]:
    """Flax GSR-Net param tree (numpy or array-like leaves) -> state_dict
    mapping of float32 numpy arrays."""
    p = params["params"]
    net = p["net"]
    n_levels = sum(1 for k in net if k.startswith("down_gcns_"))
    out = {"layer.weights": np.asarray(p["layer"]["weights"], np.float32),
           "gc1.weight": np.asarray(p["gc1"]["weight"], np.float32),
           "gc2.weight": np.asarray(p["gc2"]["weight"], np.float32)}
    for name in lin_names(n_levels):
        dense = net[name]["proj"]
        prefix = _torch_prefix(name)
        out[f"{prefix}.weight"] = np.ascontiguousarray(
            np.asarray(dense["kernel"], np.float32).T)
        out[f"{prefix}.bias"] = np.asarray(dense["bias"], np.float32)
    return out


def state_to_flax(state: Mapping[str, np.ndarray]):
    """Inverse of ``flax_to_state``."""
    net = {}
    for name in lin_names(_n_levels(state)):
        prefix = _torch_prefix(name)
        net[name] = {"proj": {
            "kernel": np.ascontiguousarray(np.asarray(state[f"{prefix}.weight"],
                                                      np.float32).T),
            "bias": np.asarray(state[f"{prefix}.bias"], np.float32)}}
    return {"params": {
        "layer": {"weights": np.asarray(state["layer.weights"], np.float32)},
        "net": net,
        "gc1": {"weight": np.asarray(state["gc1.weight"], np.float32)},
        "gc2": {"weight": np.asarray(state["gc2.weight"], np.float32)}}}


def state_to_leaves(state: Mapping[str, np.ndarray]) -> List[np.ndarray]:
    """state_dict -> the training kernels' 34-leaf list (at 4 levels)."""
    names = lin_names(_n_levels(state))
    ws = [np.asarray(state[f"{_torch_prefix(n)}.weight"], np.float32).T
          for n in names]
    w_end = ws.pop()
    half = w_end.shape[1]
    ws += [w_end[:half], w_end[half:]]
    bs = [np.asarray(state[f"{_torch_prefix(n)}.bias"], np.float32)[None, :]
          for n in names]
    tail = [np.asarray(state[k], np.float32)
            for k in ("layer.weights", "gc1.weight", "gc2.weight")]
    return [np.ascontiguousarray(a) for a in ws + bs + tail]


def leaves_to_state(leaves: List[np.ndarray]) -> Dict[str, np.ndarray]:
    """Inverse of ``state_to_leaves``."""
    n_mod = (len(leaves) - 4) // 2
    names = lin_names((n_mod - 3) // 3)
    ws, bs = leaves[:n_mod + 1], leaves[n_mod + 1:2 * n_mod + 1]
    ws = ws[:n_mod - 1] + [np.concatenate([ws[n_mod - 1], ws[n_mod]], 0)]
    out = {}
    for name, w, b in zip(names, ws, bs):
        prefix = _torch_prefix(name)
        out[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(w).T)
        out[f"{prefix}.bias"] = np.asarray(b).reshape(-1)
    for key, a in zip(("layer.weights", "gc1.weight", "gc2.weight"),
                      leaves[2 * n_mod + 1:]):
        out[key] = np.asarray(a)
    return out


def leaves_to_flat(leaves: List[np.ndarray]) -> np.ndarray:
    return np.concatenate([np.asarray(a, np.float32).reshape(-1)
                           for a in leaves])


def flat_to_leaves(flat: np.ndarray, shapes) -> List[np.ndarray]:
    out, off = [], 0
    for shape in shapes:
        size = int(np.prod(shape))
        out.append(np.asarray(flat[off:off + size]).reshape(shape))
        off += size
    if off != flat.shape[-1]:
        raise ValueError(f"flat vector has {flat.shape[-1]} values, the "
                         f"leaf shapes {off}")
    return out


def state_to_flat(state: Mapping[str, np.ndarray]) -> np.ndarray:
    return leaves_to_flat(state_to_leaves(state))


def flat_to_state(flat: np.ndarray, shapes) -> Dict[str, np.ndarray]:
    return leaves_to_state(flat_to_leaves(flat, shapes))


def state_to_leaf_tensors(state: Mapping[str, "torch.Tensor"]):
    """state_dict-named tensors -> {leaf name: tensor} in ``leaf_names``
    order, differentiably: Linear weights transposed to (in, out) and made
    contiguous (a copy), ``end_gcn`` split in halves, biases as (1, out).
    A leading fold axis on every tensor is carried through."""
    names = lin_names(_n_levels(state))
    out = {}
    for n in names:
        w = state[f"{_torch_prefix(n)}.weight"].transpose(-1, -2).contiguous()
        if n == "end_gcn":
            half = w.shape[-2] // 2
            out["w:end_gcn_a"] = w[..., :half, :]
            out["w:end_gcn_b"] = w[..., half:, :]
        else:
            out[f"w:{n}"] = w
    for n in names:
        out[f"b:{n}"] = state[f"{_torch_prefix(n)}.bias"].unsqueeze(-2)
    for key in TAIL_NAMES:
        out[key] = state[key]
    return out


def leaf_tensors_to_state(leaves: Mapping[str, "torch.Tensor"]):
    """Inverse of ``state_to_leaf_tensors``, differentiably and without a
    copy but for ``end_gcn`` (its halves are concatenated): Linear weights
    are transposed views of the leaves."""
    import torch
    n_levels = sum(1 for k in leaves if k.startswith("b:down_gcns_"))
    out = {}
    for n in lin_names(n_levels):
        if n == "end_gcn":
            w = torch.cat([leaves["w:end_gcn_a"], leaves["w:end_gcn_b"]], -2)
        else:
            w = leaves[f"w:{n}"]
        prefix = _torch_prefix(n)
        out[f"{prefix}.weight"] = w.transpose(-1, -2)
        out[f"{prefix}.bias"] = leaves[f"b:{n}"].squeeze(-2)
    for key in TAIL_NAMES:
        out[key] = leaves[key]
    return out


# ---------------------------------------------------------------------------
# GAT Graph-U-Net
# ---------------------------------------------------------------------------
# Three layouts again:
#
# * the JAX package's flax tree: per GAT layer ``w`` (in, heads * d_head),
#   ``att_src`` / ``att_dst`` (heads, d_head), ``bias`` (heads * d_head,);
#   ``pools_{i}.proj`` and ``upsampler.upsample_mlp`` Dense (kernel (in, out));
# * the port's ``state_dict`` names - the reference's torch names, with its
#   PyG ``GATConv`` as submodule ``gat``:
#
#       {down_gcns,up_gcns}.{i}.gat.lin.weight    (heads * d_head, in) = w.T
#       ....gat.att_src / att_dst                 (1, heads, d_head)
#       ....gat.bias                              (heads * d_head,)
#       bottom_gcn.gat.*                          (2 heads)
#       pools.{i}.proj.{weight,bias}              Linear(in, 1)
#       upsampler.upsample_mlp.{weight,bias}      Linear(n_nodes, m_nodes)
#
#   (the reference reverses its up_gcns after construction, so ``up_gcns.{i}``
#   is the i-th layer in execution order in both);
# * the fused step's canonical leaf order (``gat_leaf_names``): per GAT layer
#   in forward order (down levels, bottom, up levels) ``w, att_src, att_dst,
#   bias (1, out)``, then per pool ``kernel (in, 1), bias (1, 1)``, then the
#   upsampler's ``kernel (n, m), bias (1, m)``; flattened leaf after leaf
#   into one (P,) vector per fold.

_GAT_LAYER_LEAVES = ("w", "att_src", "att_dst", "bias")


def gat_dims(dim: int, ks) -> List[int]:
    """Per-level feature widths, ``int(width / k)`` per level: 16 -> 32 ->
    64 -> 128 at the shipped config."""
    dims = [dim]
    for k in ks:
        dims.append(int(dims[-1] / k))
    return dims


def gat_layer_specs(dim: int, ks, heads: int):
    """(flax module name, in_dim, out_dim, heads) of every GAT layer in
    forward order: down levels, bottom (always 2 heads), up levels."""
    L = len(ks)
    dims = gat_dims(dim, ks)
    specs = [(f"down_gcns_{i}", dims[i], dims[i + 1], heads)
             for i in range(L)]
    specs.append(("bottom_gcn", dims[-1], dims[-1], 2))
    specs += [(f"up_gcns_{i}", dims[L - i], dims[L - i - 1], heads)
              for i in range(L)]
    return specs


def _gat_layer_modules(n_levels: int) -> List[str]:
    return ([f"down_gcns_{i}" for i in range(n_levels)] + ["bottom_gcn"]
            + [f"up_gcns_{i}" for i in range(n_levels)])


def gat_leaf_names(n_levels: int) -> List[str]:
    """``<flax module>.<leaf>`` of the fused step's leaves in their order
    (36 at 3 levels)."""
    names = [f"{mod}.{leaf}" for mod in _gat_layer_modules(n_levels)
             for leaf in _GAT_LAYER_LEAVES]
    for i in range(n_levels):
        names += [f"pools_{i}.kernel", f"pools_{i}.bias"]
    return names + ["upsampler.kernel", "upsampler.bias"]


def gat_leaf_shapes(dim: int, ks, heads: int, n_nodes: int, m_nodes: int):
    """Shapes of ``gat_leaf_names``'s leaves. Layer widths are
    ``heads * (out // heads)``, as the parameters are built."""
    shapes = []
    for _, in_d, out_d, h in gat_layer_specs(dim, ks, heads):
        d_head = out_d // h
        shapes += [(in_d, h * d_head), (h, d_head), (h, d_head),
                   (1, h * d_head)]
    dims = gat_dims(dim, ks)
    for i in range(len(ks)):
        shapes += [(dims[i + 1], 1), (1, 1)]
    return shapes + [(n_nodes, m_nodes), (1, m_nodes)]


def _gat_torch_prefix(flax_name: str) -> str:
    """``down_gcns_2`` -> ``down_gcns.2.gat``; ``bottom_gcn`` ->
    ``bottom_gcn.gat``; ``pools_1`` -> ``pools.1.proj``."""
    head, _, tail = flax_name.rpartition("_")
    if tail.isdigit():
        return f"{head}.{tail}." + ("proj" if head == "pools" else "gat")
    return f"{flax_name}.gat"


def _gat_n_levels(state) -> int:
    return sum(1 for k in state
               if k.startswith("pools.") and k.endswith(".proj.bias"))


def gat_flax_to_state(params) -> Dict[str, np.ndarray]:
    """Flax GATGraphUnet param tree (numpy or array-like leaves) ->
    state_dict mapping of float32 numpy arrays."""
    p = params["params"]
    n_levels = sum(1 for k in p if k.startswith("pools_"))

    def arr(a):
        return np.ascontiguousarray(np.asarray(a, np.float32))

    out = {}
    for mod in _gat_layer_modules(n_levels):
        prefix = _gat_torch_prefix(mod)
        out[f"{prefix}.lin.weight"] = arr(np.asarray(p[mod]["w"]).T)
        out[f"{prefix}.att_src"] = arr(p[mod]["att_src"])[None]
        out[f"{prefix}.att_dst"] = arr(p[mod]["att_dst"])[None]
        out[f"{prefix}.bias"] = arr(p[mod]["bias"])
    for i in range(n_levels):
        proj = p[f"pools_{i}"]["proj"]
        out[f"pools.{i}.proj.weight"] = arr(np.asarray(proj["kernel"]).T)
        out[f"pools.{i}.proj.bias"] = arr(proj["bias"])
    up = p["upsampler"]["upsample_mlp"]
    out["upsampler.upsample_mlp.weight"] = arr(np.asarray(up["kernel"]).T)
    out["upsampler.upsample_mlp.bias"] = arr(up["bias"])
    return out


def gat_state_to_flax(state: Mapping[str, np.ndarray]):
    """Inverse of ``gat_flax_to_state``."""
    n_levels = _gat_n_levels(state)

    def arr(key):
        return np.asarray(state[key], np.float32)

    tree = {}
    for mod in _gat_layer_modules(n_levels):
        prefix = _gat_torch_prefix(mod)
        tree[mod] = {"w": np.ascontiguousarray(arr(f"{prefix}.lin.weight").T),
                     "att_src": arr(f"{prefix}.att_src")[0],
                     "att_dst": arr(f"{prefix}.att_dst")[0],
                     "bias": arr(f"{prefix}.bias")}
    for i in range(n_levels):
        tree[f"pools_{i}"] = {"proj": {
            "kernel": np.ascontiguousarray(arr(f"pools.{i}.proj.weight").T),
            "bias": arr(f"pools.{i}.proj.bias")}}
    tree["upsampler"] = {"upsample_mlp": {
        "kernel": np.ascontiguousarray(
            arr("upsampler.upsample_mlp.weight").T),
        "bias": arr("upsampler.upsample_mlp.bias")}}
    return {"params": tree}


def gat_state_to_leaves(state: Mapping[str, np.ndarray]) -> List[np.ndarray]:
    """state_dict -> the fused step's leaf list (``gat_leaf_names``)."""
    n_levels = _gat_n_levels(state)

    def arr(key):
        return np.asarray(state[key], np.float32)

    leaves = []
    for mod in _gat_layer_modules(n_levels):
        prefix = _gat_torch_prefix(mod)
        leaves += [arr(f"{prefix}.lin.weight").T, arr(f"{prefix}.att_src")[0],
                   arr(f"{prefix}.att_dst")[0], arr(f"{prefix}.bias")[None]]
    for i in range(n_levels):
        leaves += [arr(f"pools.{i}.proj.weight").T,
                   arr(f"pools.{i}.proj.bias")[None]]
    leaves += [arr("upsampler.upsample_mlp.weight").T,
               arr("upsampler.upsample_mlp.bias")[None]]
    return [np.ascontiguousarray(a) for a in leaves]


def gat_leaves_to_state(leaves: List[np.ndarray]) -> Dict[str, np.ndarray]:
    """Inverse of ``gat_state_to_leaves``."""
    n_levels = (len(leaves) - 6) // 10
    return {k: np.ascontiguousarray(v) for k, v in gat_leaf_tensors_to_state(
        dict(zip(gat_leaf_names(n_levels),
                 (np.asarray(a) for a in leaves)))).items()}


def gat_state_to_flat(state: Mapping[str, np.ndarray]) -> np.ndarray:
    return leaves_to_flat(gat_state_to_leaves(state))


def gat_flat_to_state(flat: np.ndarray, shapes) -> Dict[str, np.ndarray]:
    return gat_leaves_to_state(flat_to_leaves(flat, shapes))


def gat_leaf_tensors_to_state(leaves: Mapping[str, "torch.Tensor"]):
    """{leaf name: tensor or array} -> state_dict names, as views (weights
    transposed, biases squeezed), so tensors stay differentiable: how the
    unfused trainer reads a model out of the flat buffer. 2-D leaves only
    (one model)."""
    n_levels = sum(1 for k in leaves if k.startswith("pools_")) // 2
    out = {}
    for mod in _gat_layer_modules(n_levels):
        prefix = _gat_torch_prefix(mod)
        out[f"{prefix}.lin.weight"] = leaves[f"{mod}.w"].T
        out[f"{prefix}.att_src"] = leaves[f"{mod}.att_src"][None]
        out[f"{prefix}.att_dst"] = leaves[f"{mod}.att_dst"][None]
        out[f"{prefix}.bias"] = leaves[f"{mod}.bias"][0]
    for i in range(n_levels):
        out[f"pools.{i}.proj.weight"] = leaves[f"pools_{i}.kernel"].T
        out[f"pools.{i}.proj.bias"] = leaves[f"pools_{i}.bias"][0]
    out["upsampler.upsample_mlp.weight"] = leaves["upsampler.kernel"].T
    out["upsampler.upsample_mlp.bias"] = leaves["upsampler.bias"][0]
    return out


# ---------------------------------------------------------------------------
# The MLP family (models/mlp.py)
# ---------------------------------------------------------------------------
# v2, SpectralResMLP, under the reference notebook's torch names (legacy
# ``torch.nn.utils.spectral_norm``), as fcsr_tpu/iox/torch_interop.py maps
# them:
#   input_layer.1.{weight_orig,bias,weight_u,weight_v}    SN Linear(L_in, h)
#   input_layer.2.{weight,bias,running_mean,running_var}  BatchNorm1d(h)
#   residual_blocks.{i}.0.* / residual_blocks.{i}.1.*     (n_layers blocks)
#   output_layer.0.{weight_orig,bias,weight_u,weight_v}   SN Linear(h, L_out)
# v1, SuperResMLP, has no torch mapping in the JAX package: each module is
# named after its flax path and each leaf as torch names it:
#   Dense_{i}.{weight,bias}                                Linear (out, in)
#   TorchBatchNorm_{i}.{weight,bias,running_mean,running_var}
# Leaf by leaf: a Dense kernel (in, out) is ``weight`` / ``weight_orig``
# (out, in) transposed; BatchNorm scale / bias / mean / var are weight /
# bias / running_mean / running_var; spectral-norm u / v are weight_u /
# weight_v. The flat layouts (``models/mlp.py::MLPLayout``) hold the flax
# leaves, named ``<flax module>.<flax leaf>``, module after module: the
# parameters in one (P,) vector per fold, the statistics (BatchNorm mean
# and var, spectral-norm u and v) in one (S,) vector per fold.

# (flax leaf, torch leaf, transposed) by module kind
_MLP_PARAMS = {
    "sn": (("kernel", "weight_orig", True), ("bias", "bias", False)),
    "dense": (("kernel", "weight", True), ("bias", "bias", False)),
    "bn": (("scale", "weight", False), ("bias", "bias", False))}
_MLP_STATS = {"sn": (("u", "weight_u"), ("v", "weight_v")), "dense": (),
              "bn": (("mean", "running_mean"), ("var", "running_var"))}


def _mlp_modules(variant: str, n_layers: int):
    """[(flax module, torch prefix, kind)] in layout order."""
    if variant == "v2":
        mods = [("input_dense", "input_layer.1", "sn"),
                ("input_bn", "input_layer.2", "bn")]
        for i in range(n_layers):
            mods += [(f"res_dense_{i}", f"residual_blocks.{i}.0", "sn"),
                     (f"res_bn_{i}", f"residual_blocks.{i}.1", "bn")]
        return mods + [("output_dense", "output_layer.0", "sn")]
    if variant == "v1":
        mods = []
        for i in range(n_layers):
            mods += [(f"Dense_{i}", f"Dense_{i}", "dense"),
                     (f"TorchBatchNorm_{i}", f"TorchBatchNorm_{i}", "bn")]
        return mods + [(f"Dense_{n_layers}", f"Dense_{n_layers}", "dense")]
    raise ValueError(f"unknown MLP variant: {variant!r}")


def mlp_entries(variant: str, n_layers: int):
    """(params, stats) in layout order: [(leaf, torch name, transposed)]
    and [(leaf, torch name)], leaf = ``<flax module>.<flax leaf>``."""
    params, stats = [], []
    for mod, prefix, kind in _mlp_modules(variant, n_layers):
        params += [(f"{mod}.{a}", f"{prefix}.{b}", t)
                   for a, b, t in _MLP_PARAMS[kind]]
        stats += [(f"{mod}.{a}", f"{prefix}.{b}") for a, b in _MLP_STATS[kind]]
    return params, stats


def _mlp_kind(names) -> Tuple[str, int]:
    """(variant, n_layers) from torch names or flax module names."""
    names = list(names)
    if any(k.startswith(("input_layer.", "input_dense")) for k in names):
        blocks = {k.split(".")[1] for k in names
                  if k.startswith("residual_blocks.")}
        blocks |= {k for k in names if k.startswith("res_dense_")}
        return "v2", len(blocks)
    return "v1", len({k.split(".")[0] for k in names
                      if k.startswith("TorchBatchNorm_")})


def mlp_flax_to_state(variables) -> Dict[str, np.ndarray]:
    """The JAX package's MLP variables ``{"params", "batch_stats"}`` (numpy
    or array-like leaves) -> state_dict mapping of float32 numpy arrays."""
    p, bs = variables["params"], variables.get("batch_stats", {})
    params, stats = mlp_entries(*_mlp_kind(p))

    def arr(tree, leaf):
        mod, name = leaf.split(".")
        return np.asarray(tree[mod][name], np.float32)

    out = {}
    for leaf, tname, transposed in params:
        a = arr(p, leaf)
        out[tname] = np.ascontiguousarray(a.T if transposed else a)
    for leaf, tname in stats:
        out[tname] = np.ascontiguousarray(arr(bs, leaf))
    return out


def mlp_state_to_flax(state: Mapping[str, np.ndarray]):
    """Inverse of ``mlp_flax_to_state``; a reference ``state_dict``'s
    ``num_batches_tracked`` entries are ignored."""
    params, stats = mlp_entries(*_mlp_kind(state))
    out = {"params": {}, "batch_stats": {}}
    for coll, entries in (("params", params),
                          ("batch_stats", [(a, b, False) for a, b in stats])):
        for leaf, tname, transposed in entries:
            mod, name = leaf.split(".")
            a = np.asarray(state[tname], np.float32)
            out[coll].setdefault(mod, {})[name] = np.ascontiguousarray(
                a.T if transposed else a)
    return out


def mlp_state_to_leaves(state: Mapping[str, "torch.Tensor"]):
    """state_dict -> ({param leaf: tensor}, {stat leaf: tensor}) in layout
    order, as views (kernels transposed), so tensors stay differentiable:
    how a module reads its own weights into ``fold_forward``."""
    params, stats = mlp_entries(*_mlp_kind(state))
    return ({leaf: state[t].T if tr else state[t] for leaf, t, tr in params},
            {leaf: state[t] for leaf, t in stats})


def mlp_leaves_to_state(p_leaves: Mapping, s_leaves: Mapping):
    """Inverse of ``mlp_state_to_leaves`` (views for tensors)."""
    params, stats = mlp_entries(*_mlp_kind(
        k.split(".")[0] for k in p_leaves))
    out = {t: p_leaves[leaf].T if tr else p_leaves[leaf]
           for leaf, t, tr in params}
    out.update({t: s_leaves[leaf] for leaf, t in stats})
    return out


def mlp_state_to_flat(state: Mapping[str, np.ndarray]):
    """state_dict -> (params (P,), stats (S,)) float32 in layout order."""
    p_leaves, s_leaves = mlp_state_to_leaves(
        {k: np.asarray(v, np.float32) for k, v in state.items()})
    return tuple(np.concatenate([np.ascontiguousarray(a).reshape(-1)
                                 for a in leaves.values()])
                 for leaves in (p_leaves, s_leaves))


def mlp_flat_to_state(p: np.ndarray, s: np.ndarray, layout):
    """(params (P,), stats (S,)) and a ``models/mlp.py::MLPLayout`` ->
    state_dict mapping of float32 numpy arrays."""
    views = [{k: v[0] for k, v in spec.views(
        np.asarray(buf, np.float32).reshape(1, -1)).items()}
        for spec, buf in ((layout.params, p), (layout.stats, s))]
    return {k: np.ascontiguousarray(v)
            for k, v in mlp_leaves_to_state(*views).items()}


# ------------------------------------------------- GraphSAGE upsampler
# flax ``{"params": {"gcn_{i}": {"omega", "beta"}}}`` <-> the port's
# ``gcn.{i}.omega`` / ``gcn.{i}.beta`` (``models/upsample.py``; the names
# follow the port's module tree, as the reference's torch names for this
# model are not recorded). omega is (in, out) on both sides.

def upsample_flax_to_state(params) -> Dict[str, np.ndarray]:
    """The JAX package's ``GraphSAGEUpsampler`` variables -> state_dict
    mapping of float32 numpy arrays."""
    p = params["params"]
    return {f"gcn.{i}.{leaf}": np.asarray(p[f"gcn_{i}"][leaf], np.float32)
            for i in range(len(p)) for leaf in ("omega", "beta")}


def upsample_state_to_flax(state: Mapping[str, np.ndarray]):
    """Inverse of ``upsample_flax_to_state``."""
    n = sum(1 for k in state if k.endswith(".omega"))
    return {"params": {f"gcn_{i}": {
        leaf: np.asarray(state[f"gcn.{i}.{leaf}"], np.float32)
        for leaf in ("omega", "beta")} for i in range(n)}}
