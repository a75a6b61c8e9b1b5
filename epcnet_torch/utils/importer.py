"""One-way weight importer: reference checkpoints -> the port's flat
variables (counterpart of ``epcnet_tpu/utils/importer.py``, numpy only).

The port's weights are a flat dict in the naming of ``weights.py``
(``params/<module path>/<leaf>``, ``batch_stats/<module path>/<leaf>``,
Dense kernels [in, out]), which ``weights.load_flat_variables`` loads into
a model. This module maps external state dicts onto it:

  - per-point "conv2d with 1x1 kernel" variables -> Dense kernel/bias
    (TF kernels [1, 1, Cin, Cout] / torch [Cout, Cin, 1, 1] -> [Cin, Cout])
  - batch-norm gamma/beta/moving_mean/moving_variance -> BN scale/bias +
    batch_stats mean/var
  - NetVLAD cluster weights/centroids -> the VLAD head's assign kernel +
    centroids

Name mapping is data-driven (a dict of regex -> target path, ``NAME_MAPS``,
the JAX package's maps), and an unlabelled dict goes through the shape
matcher (``automatch_state_dict``). Every result is a flat dict that
``merge_into_variables`` overlays on a full one (``init_flat_variables``),
checking names and shapes.
"""

from __future__ import annotations

import re
import warnings
from typing import Any, Mapping

import numpy as np


def _to_numpy(v) -> np.ndarray:
    if hasattr(v, "detach"):  # torch tensor
        return v.detach().cpu().numpy()
    return np.asarray(v)


def convert_dense(weight: np.ndarray, source: str) -> np.ndarray:
    """Any conv1x1/dense weight layout -> Dense [Cin, Cout]."""
    w = np.asarray(weight)
    if source == "torch":
        # torch Linear [Cout, Cin]; Conv2d 1x1 [Cout, Cin, 1, 1]
        if w.ndim == 4:
            w = w[:, :, 0, 0]
        return w.T
    # TF conv2d [1, 1, Cin, Cout]; dense [Cin, Cout]
    if w.ndim == 4:
        w = w[0, 0]
    return w


# ----------------------------------------------------------------------------
# The JAX package's name maps, unchanged: TF1 variable names of the public
# PointNetVLAD code (mikacuy/pointnetvlad) that EPC-Net forks, unverified
# against a real reference checkpoint (none was available).
# ----------------------------------------------------------------------------

def _tnet_map(scope: str, target: str, transform_var: str) -> dict:
    m = {}
    for i in (1, 2, 3):  # tconv1..3 -> mlp dense_0..2
        m[rf"{scope}/tconv{i}/weights"] = f"{target}/mlp/dense_{i-1}/kernel"
        m[rf"{scope}/tconv{i}/biases"] = f"{target}/mlp/dense_{i-1}/bias"
        m[rf"{scope}/tconv{i}/bn/gamma"] = f"{target}/mlp/bn_{i-1}/scale"
        m[rf"{scope}/tconv{i}/bn/beta"] = f"{target}/mlp/bn_{i-1}/bias"
        m[rf"{scope}/tconv{i}/bn/moving_mean"] = f"{target}/mlp/bn_{i-1}/mean"
        m[rf"{scope}/tconv{i}/bn/moving_variance"] = f"{target}/mlp/bn_{i-1}/var"
    for i in (1, 2):  # tfc1..2 -> fc dense_0..1
        m[rf"{scope}/tfc{i}/weights"] = f"{target}/fc/dense_{i-1}/kernel"
        m[rf"{scope}/tfc{i}/biases"] = f"{target}/fc/dense_{i-1}/bias"
        m[rf"{scope}/tfc{i}/bn/gamma"] = f"{target}/fc/bn_{i-1}/scale"
        m[rf"{scope}/tfc{i}/bn/beta"] = f"{target}/fc/bn_{i-1}/bias"
        m[rf"{scope}/tfc{i}/bn/moving_mean"] = f"{target}/fc/bn_{i-1}/mean"
        m[rf"{scope}/tfc{i}/bn/moving_variance"] = f"{target}/fc/bn_{i-1}/var"
    m[rf"{scope}/{transform_var}/weights"] = f"{target}/transform_w"
    m[rf"{scope}/{transform_var}/biases"] = f"{target}/transform_b"
    return m


def _conv_bn_map(src: str, dst: str) -> dict:
    return {
        rf"{src}/weights": f"{dst}/kernel",
        rf"{src}/biases": f"{dst}/bias",
    }


def _tf1_pointnetvlad_map() -> dict:
    m = {}
    m.update(_tnet_map("transform_net1", "input_tnet", "transform_XYZ"))
    m.update(_tnet_map("transform_net2", "feature_tnet", "transform_feat"))
    # conv1..2 (pre feature-transform) -> mlp1; conv3..5 -> mlp2
    for i, (blk, j) in enumerate(
        [("mlp1", 0), ("mlp1", 1), ("mlp2", 0), ("mlp2", 1), ("mlp2", 2)], start=1
    ):
        m.update(_conv_bn_map(f"conv{i}", f"{blk}/dense_{j}"))
        m[rf"conv{i}/bn/gamma"] = f"{blk}/bn_{j}/scale"
        m[rf"conv{i}/bn/beta"] = f"{blk}/bn_{j}/bias"
        m[rf"conv{i}/bn/moving_mean"] = f"{blk}/bn_{j}/mean"
        m[rf"conv{i}/bn/moving_variance"] = f"{blk}/bn_{j}/var"
    # NetVLAD head (PointNetVLAD's VLAD + context gating variables)
    m[r"(?:vlad/)?cluster_weights"] = "netvlad/assign/kernel"
    m[r"(?:vlad/)?cluster_biases"] = "netvlad/assign/bias"
    m[r"(?:vlad/)?cluster_weights2"] = "netvlad/centroids"
    m[r"(?:vlad/)?hidden1_weights"] = "netvlad/group_w"
    m[r"(?:vlad/)?hidden1_biases"] = "netvlad/group_b"
    m[r"(?:vlad/)?gating_weights"] = "netvlad/gate/kernel"
    m[r"(?:vlad/)?gating_biases"] = "netvlad/gate/bias"
    return m


def _tf1_epcnet_map() -> dict:
    """Best-guess TF1 EPC-Net variable names -> the EPCNet naming: regex
    alternation accepts the likely spellings (pconv{i} / proxyconv{i} /
    epc_conv{i}; lift convs conv5/conv6 or agg1/agg2). Where none match,
    :func:`automatch_state_dict` needs no names at all."""
    m = {}
    for i in (1, 2, 3, 4):  # ProxyConv stack (paper: 4 layers)
        src = rf"(?:pconv|proxyconv|proxy_conv|epc_conv){i}"
        dst = f"proxyconv_{i - 1}"
        m[rf"{src}/weights"] = f"{dst}/dense/kernel"
        m[rf"{src}/biases"] = f"{dst}/dense/bias"
        m[rf"{src}/bn/gamma"] = f"{dst}/bn/scale"
        m[rf"{src}/bn/beta"] = f"{dst}/bn/bias"
        m[rf"{src}/bn/moving_mean"] = f"{dst}/bn/mean"
        m[rf"{src}/bn/moving_variance"] = f"{dst}/bn/var"
    for j, i in enumerate((5, 6)):  # per-point lift of the multi-scale concat
        src = rf"(?:conv{i}|agg{j + 1}|lift{j + 1})"
        m[rf"{src}/weights"] = f"lift/dense_{j}/kernel"
        m[rf"{src}/biases"] = f"lift/dense_{j}/bias"
        m[rf"{src}/bn/gamma"] = f"lift/bn_{j}/scale"
        m[rf"{src}/bn/beta"] = f"lift/bn_{j}/bias"
        m[rf"{src}/bn/moving_mean"] = f"lift/bn_{j}/mean"
        m[rf"{src}/bn/moving_variance"] = f"lift/bn_{j}/var"
    # G-VLAD head: NetVLAD heritage names + grouped/out FC + gating
    m[r"(?:g?vlad/)?cluster_weights"] = "gvlad/assign/kernel"
    m[r"(?:g?vlad/)?cluster_biases"] = "gvlad/assign/bias"
    m[r"(?:g?vlad/)?cluster_weights2"] = "gvlad/centroids"
    m[r"(?:g?vlad/)?(?:hidden1|group)_weights"] = "gvlad/group_w"
    m[r"(?:g?vlad/)?(?:hidden1|group)_biases"] = "gvlad/group_b"
    m[r"(?:g?vlad/)?(?:hidden2|out)_weights"] = "gvlad/out_fc/kernel"
    m[r"(?:g?vlad/)?(?:hidden2|out)_biases"] = "gvlad/out_fc/bias"
    m[r"(?:g?vlad/)?gating_weights"] = "gvlad/gate/kernel"
    m[r"(?:g?vlad/)?gating_biases"] = "gvlad/gate/bias"
    return m


NAME_MAPS: dict[str, dict] = {
    # TF1 tf.train.Saver variable names of the PointNetVLAD family; source="tf"
    "tf1_pointnetvlad": _tf1_pointnetvlad_map(),
    # the best-guess EPC-Net map
    "tf1_epcnet": _tf1_epcnet_map(),
}


def _flat_name(path: str) -> str:
    """A module path ``a/b/leaf`` -> its flat name (BN mean/var are
    ``batch_stats``, everything else ``params``)."""
    leaf = path.rsplit("/", 1)[-1]
    return ("batch_stats/" if leaf in ("mean", "var") else "params/") + path


def import_state_dict(state_dict: Mapping[str, Any], name_map: Mapping[str, str],
                      source: str = "torch") -> dict[str, np.ndarray]:
    """Map a reference state dict onto flat variables.

    name_map: {regex -> "/"-joined module path with capture-group refs},
    e.g. {r"proxy_convs\\.(\\d+)\\.weight": r"proxyconv_\\1/dense/kernel"}.
    Target leaf names: kernel|bias|scale|mean|var|centroids|group_w|group_b.
    Unmatched source keys are skipped with a warning that names them.
    Returns {flat name: array}."""
    out: dict[str, np.ndarray] = {}
    skipped = []
    for key, val in state_dict.items():
        target = None
        for pat, tmpl in name_map.items():
            m = re.fullmatch(pat, key)
            if m:
                target = m.expand(tmpl)
                break
        if target is None:
            skipped.append(key)
            continue
        arr = _to_numpy(val)
        leaf = target.rsplit("/", 1)[-1]
        if leaf == "kernel":
            arr = convert_dense(arr, source)
        elif leaf == "centroids":
            # TF stores cluster centres [1, D, K] (or [D, K]); ours is [K, D]
            if source == "tf":
                if arr.ndim == 3:
                    arr = arr[0]
                arr = arr.T
        elif leaf == "group_w":
            if source == "torch" and arr.ndim == 2:
                arr = arr.T  # torch Linear [out, in] -> [in, out]
            if arr.ndim == 2:  # single dense FC -> grouped FC with G=1
                arr = arr[None]
        elif leaf == "group_b" and arr.ndim == 1:
            arr = arr[None]
        out[_flat_name(target)] = arr
    if skipped:
        warnings.warn(f"importer skipped {len(skipped)} keys: {skipped[:5]}...")
    return out


# ----------------------------------------------------------------------------
# Shape-graph auto-matcher: import an UNLABELLED state dict.
# ----------------------------------------------------------------------------


def model_leaf_order(variables: Mapping[str, Any]) -> list[tuple[str, str, tuple]]:
    """The leaf order of flat variables that the auto-matcher walks.

    Builds the module tree from the ``params/...`` names in their order
    and walks it as the JAX function walks a flax tree: each module's
    leaves and children in order, each module's ``batch_stats`` (mean, var)
    right after its params, the per-layer (kernel, bias, scale, bias, mean,
    var) grouping of TF1 Saver lists and torch state_dicts. The port's own
    flat order (``flat_variables``, ``init_flat_variables``) is its modules'
    registration order, a module's own parameters before its children's,
    as a torch ``state_dict()`` lists them.

    Returns [(tree, "/"-path, shape)] with tree in {"params", "stats"}."""
    params: dict = {}
    stats: dict = {}
    for name, v in variables.items():
        section, _, path = name.partition("/")
        node = {"params": params, "batch_stats": stats}[section]
        *mods, leaf = path.split("/")
        for p in mods:
            node = node.setdefault(p, {})
        node[leaf] = v
    order: list[tuple[str, str, tuple]] = []

    def stats_at(parts):
        node = stats
        for p in parts:
            if not isinstance(node, dict) or p not in node:
                return None
            node = node[p]
        return node

    def walk(node, parts):
        emitted_leaf = False
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, parts + [k])
            else:
                order.append(("params", "/".join(parts + [k]), np.shape(v)))
                emitted_leaf = True
        if emitted_leaf:
            s = stats_at(parts)
            if isinstance(s, dict):
                order.extend(("stats", "/".join(parts + [k]), np.shape(v))
                             for k, v in s.items() if not isinstance(v, dict))

    walk(params, [])
    return order


def _conversion_candidates(arr: np.ndarray, source: str):
    """(converted array, compatible leaf kinds) candidates for one source
    var, most specific first; ``None`` leaf kinds = any leaf."""
    out = []
    if arr.ndim == 2 and source == "torch":
        # torch Linear stores [out, in]: for the same leaf the transpose
        # must outrank the identity, or a SQUARE kernel (the gating FC)
        # imports untransposed
        out.append((arr.T, ("kernel",)))
    out.append((arr, None))
    if arr.ndim == 4:  # conv 1x1 kernels
        out.append((convert_dense(arr, source), ("kernel",)))
    if arr.ndim == 3 and source == "tf":
        out.append((arr[0].T, ("centroids",)))  # TF NetVLAD centroids [1, D, K]
    if arr.ndim == 2:
        if source != "torch":
            out.append((arr.T, ("centroids",)))  # TF centroids [D, K]
        out.append((arr[None], ("group_w",)))  # dense FC -> G=1 grouped
    if arr.ndim == 1:
        out.append((arr[None], ("group_b",)))
    return out


def automatch_state_dict(state_dict: Mapping[str, Any], variables: Mapping[str, Any],
                         source: str = "tf") -> dict[str, np.ndarray]:
    """Match an UNLABELLED state dict onto ``variables`` (a full flat dict,
    e.g. ``init_flat_variables``) by shape and leaf order.

    Contract: ``state_dict`` lists its variables in the order of
    :func:`model_leaf_order` with the usual per-layer grouping. Each source
    var goes to the FIRST still-unmatched leaf (in that order) that one of
    its layout conversions fits; for the same leaf, the first conversion
    listed wins. (The JAX function tries conversions first and leaves
    second; the two agree on a dict in leaf order with TF layouts, but for
    a torch dict whose head lists the centroids [K, D] before an assign
    Linear [K, D], as the port's state_dict does, only the leaf-first walk
    keeps the centroids off the assign kernel, whose [D, K] is the
    centroids' transpose.) Raises if any leaf ends up unmatched or any
    source var matches nothing, so a half-import is impossible.

    Returns {flat name: array} for :func:`merge_into_variables`."""
    targets = model_leaf_order(variables)
    taken = [False] * len(targets)
    out: dict[str, np.ndarray] = {}
    unmatched_src = []
    for key, val in state_dict.items():
        arr = _to_numpy(val)
        cands = _conversion_candidates(arr, source)
        for i, (tree, path, tshape) in enumerate(targets):
            if taken[i]:
                continue
            leaf = path.rsplit("/", 1)[-1]
            fit = next((c for c, kinds in cands if np.shape(c) == tshape
                        and (kinds is None or leaf in kinds)), None)
            if fit is not None:
                taken[i] = True
                out[("params/" if tree == "params" else "batch_stats/") + path] = \
                    np.asarray(fit)
                break
        else:
            unmatched_src.append((key, arr.shape))
    if unmatched_src:
        raise ValueError(f"automatch: {len(unmatched_src)} source vars matched no model "
                         f"leaf: {unmatched_src[:5]}")
    missing = [path for i, (_, path, _) in enumerate(targets) if not taken[i]]
    if missing:
        raise ValueError(f"automatch: {len(missing)} model leaves unmatched: {missing[:5]}")
    return out


def merge_into_variables(variables: Mapping[str, np.ndarray],
                         imported: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """``variables`` (a full flat dict) with the ``imported`` leaves in
    their place, cast to the leaf's dtype. Raises on a name the model does
    not have and on any shape mismatch."""
    out = dict(variables)
    for name, v in imported.items():
        if name not in variables:
            raise KeyError(f"imported key {name} absent from the model's variables")
        have = np.asarray(variables[name])
        v = np.asarray(v)
        if have.shape != v.shape:
            raise ValueError(f"shape mismatch at {name}: model {have.shape} vs "
                             f"import {v.shape}")
        out[name] = v.astype(have.dtype)
    return out
