"""Reference checkpoints in and out of the port (counterpart of the JAX
package's ``compat.py``).

The reference saves each sub-network's bare ``state_dict()`` as
``<epoch>_net_<label>.pth`` (labels ``encoder``, ``classifier``,
``segmenter``, ``decoder``).  :func:`import_run` turns such files into a
run directory of the port (``config.json`` and ``ckpt/step_*.pt``, as the
``Trainer`` writes them) that every entry point takes: ``infer``,
``serve``, ``export``, ``--pretrain`` and resumed training.
:func:`export_reference_checkpoint` writes a run of the port back out as
``.pth`` files the reference loads (the encoder with ``strict=False``:
the dead ``transformer`` sub-network has no weights here).

The conversion is key-driven numpy and goes through the JAX package's
tree layout, which the port's modules mirror by name, so ``convert.py``
stays the one table between a tree and a ``state_dict``:

==================================  =====================================
reference ``state_dict`` key        tree path (``convert.py`` -> port)
==================================  =====================================
``<net>.layers.{i}.conv.weight``    ``<net>.PointLayer_{i}.Dense_0.kernel``
  (Cout, Cin, 1[, 1]) 1x1 conv        reshaped to (Cin, Cout)
``<net>.layers.{i}.linear.weight``  the same, transposed
``....norm.{weight,bias}``          ``....BatchNorm_0.{scale,bias}``
``....norm.running_*``              batch_stats ``....BatchNorm_0.{mean,var}``
``fc_decoder.linear_out.*``         ``decoder.fc_decoder.linear_out.*``
``conv_decoder.deconv{n}.conv.*``   ``conv_decoder.UpConv_{n-1}.Conv_0``
  (Cout, Cin, 3, 3)                   kernel (3, 3, Cin, Cout)
``conv_decoder.conv2pc{j}.conv1.*`` ``conv_decoder.ConvToPC_{j-4}.PointLayer_0``
``conv_decoder.conv2pc{j}.conv2.*`` ``conv_decoder.ConvToPC_{j-4}.Dense_0``
``transformer.*``                   dropped (dead code in the reference)
``*.num_batches_tracked``           dropped (momentum here is epoch-driven)
==================================  =====================================
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import convert
from .config import Config, load_config

Tree = Dict[str, Any]

_TASK_HEADS = {"classify": "classifier", "retrieve": "classifier",
               "segment": "segmenter", "autoencode": "decoder"}


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a ``.pth`` state_dict into numpy arrays, without the
    BatchNorm step counters."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: v.detach().cpu().numpy() for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


# ---------------------------------------------------------------------------
# reference state_dict -> tree
# ---------------------------------------------------------------------------

def _group(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """The entries under ``prefix.``, the prefix stripped."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}


def _bn_tree(g: Dict[str, np.ndarray]) -> Tuple[Tree, Tree]:
    """``norm.*`` entries -> BatchNorm (params, batch_stats) leaves."""
    return ({"scale": g["norm.weight"], "bias": g["norm.bias"]},
            {"mean": g["norm.running_mean"], "var": g["norm.running_var"]})


def _point_layer(g: Dict[str, np.ndarray]) -> Tuple[Tree, Tree]:
    """One reference layer block (a 1x1 convolution or a linear layer,
    with or without its BatchNorm) -> a ``PointLayer`` subtree."""
    if "conv.weight" in g:
        w = g["conv.weight"]                       # (Cout, Cin, 1[, 1])
        kernel = w.reshape(w.shape[0], w.shape[1]).T
        bias = g["conv.bias"]
    elif "linear.weight" in g:
        kernel = g["linear.weight"].T
        bias = g["linear.bias"]
    else:
        raise ValueError(f"unrecognized layer block (keys {sorted(g)}); "
                         "expected conv.weight or linear.weight")
    params: Tree = {"Dense_0": {"kernel": kernel, "bias": bias}}
    stats: Tree = {}
    if "norm.weight" in g:
        params["BatchNorm_0"], stats["BatchNorm_0"] = _bn_tree(g)
    return params, stats


def _layer_stack(g: Dict[str, np.ndarray]) -> Tuple[Tree, Tree]:
    """A ``layers`` list -> ``PointLayer_{i}`` subtrees."""
    idx = sorted({int(k.split(".")[1]) for k in g if k.startswith("layers.")})
    params, stats = {}, {}
    for i in idx:
        p, s = _point_layer(_group(g, f"layers.{i}"))
        params[f"PointLayer_{i}"] = p
        if s:
            stats[f"PointLayer_{i}"] = s
    return params, stats


def convert_encoder(sd: Dict[str, np.ndarray]) -> Tuple[Tree, Tree]:
    """``_net_encoder.pth`` -> the encoder's (params, batch_stats):
    first_pointnet, knnlayer (som_k >= 2 only), final_pointnet; the dead
    ``transformer`` is dropped."""
    params, stats = {}, {}
    for sub in ("first_pointnet", "knnlayer", "final_pointnet"):
        g = _group(sd, sub)
        if not g:
            continue
        p, s = _layer_stack(g)
        params[sub] = p
        if s:
            stats[sub] = s
    if "first_pointnet" not in params or "final_pointnet" not in params:
        raise ValueError(
            "not an encoder state_dict (missing first_pointnet/"
            f"final_pointnet; top-level keys: "
            f"{sorted({k.split('.')[0] for k in sd})})")
    return params, stats


def convert_classifier(sd: Dict[str, np.ndarray]) -> Tuple[Tree, Tree]:
    """``_net_classifier.pth`` -> the classifier head (fc1, fc2 with
    BatchNorm, fc3 bare)."""
    params, stats = {}, {}
    for name in ("fc1", "fc2", "fc3"):
        g = _group(sd, name)
        if not g:
            raise ValueError(f"not a classifier state_dict (missing {name})")
        p, s = _point_layer(g)
        params[name] = p
        if s:
            stats[name] = s
    return params, stats


def convert_segmenter(sd: Dict[str, np.ndarray]) -> Tuple[Tree, Tree]:
    """``_net_segmenter.pth`` -> the segmenter head (layer1 .. layer5)."""
    params, stats = {}, {}
    for i in range(1, 6):
        g = _group(sd, f"layer{i}")
        if not g:
            raise ValueError(
                f"not a segmenter state_dict (missing layer{i})")
        p, s = _point_layer(g)
        params[f"layer{i}"] = p
        if s:
            stats[f"layer{i}"] = s
    return params, stats


def convert_decoder(sd: Dict[str, np.ndarray]) -> Tuple[Tree, Tree]:
    """``_net_decoder.pth`` -> the decoder (the fc_decoder linear pyramid
    and the conv_decoder UpConv / ConvToPC pyramid)."""
    params, stats = {}, {}
    fc = _group(sd, "fc_decoder")
    if fc:
        fp, fs = {}, {}
        for i, name in enumerate(("linear1", "linear2", "linear3")):
            p, s = _point_layer(_group(fc, name))
            fp[f"PointLayer_{i}"] = p
            if s:
                fs[f"PointLayer_{i}"] = s
        fp["linear_out"] = {"kernel": fc["linear_out.linear.weight"].T,
                            "bias": fc["linear_out.linear.bias"]}
        params["fc_decoder"] = fp
        if fs:
            stats["fc_decoder"] = fs
    conv = _group(sd, "conv_decoder")
    if conv:
        cp, cs = {}, {}
        for n in range(1, 7):
            g = _group(conv, f"deconv{n}.conv")
            w = g["conv.weight"]                   # (Cout, Cin, 3, 3)
            bn_p, bn_s = _bn_tree(g)
            cp[f"UpConv_{n - 1}"] = {
                "Conv_0": {"kernel": w.transpose(2, 3, 1, 0),
                           "bias": g["conv.bias"]},
                "BatchNorm_0": bn_p}
            cs[f"UpConv_{n - 1}"] = {"BatchNorm_0": bn_s}
        for j in (4, 5, 6):
            g = _group(conv, f"conv2pc{j}")
            p1, s1 = _point_layer(_group(g, "conv1"))
            w2 = g["conv2.conv.weight"]            # (3, Cin, 1, 1)
            cp[f"ConvToPC_{j - 4}"] = {
                "PointLayer_0": p1,
                "Dense_0": {"kernel": w2.reshape(3, -1).T,
                            "bias": g["conv2.conv.bias"]}}
            cs[f"ConvToPC_{j - 4}"] = {"PointLayer_0": s1}
        params["conv_decoder"] = cp
        stats["conv_decoder"] = cs
    if not params:
        raise ValueError(
            "not a decoder state_dict (no fc_decoder/conv_decoder; "
            f"top-level keys: {sorted({k.split('.')[0] for k in sd})})")
    return params, stats


_CONVERTERS = {"encoder": convert_encoder, "classifier": convert_classifier,
               "segmenter": convert_segmenter, "decoder": convert_decoder}


def _check_against_model(cfg: Config, variables: Tree) -> None:
    """The imported tree against the port's model of ``cfg``: the same
    entries with the same shapes, or a ValueError naming every
    mismatch (the model is built on the CPU and only its shapes read)."""
    from .models import build_model
    want = {k: tuple(v.shape) for k, v in convert.to_jax_variables(
        build_model(cfg, device="cpu")).items()}
    got = {k: tuple(v.shape) for k, v in convert.flatten(variables).items()}
    problems = []
    for k in sorted(set(want) | set(got)):
        if k not in got:
            problems.append(f"{k}: missing from checkpoint (model wants "
                            f"{want[k]})")
        elif k not in want:
            problems.append(f"{k}: not in the {cfg.task} model (checkpoint "
                            f"has {got[k]})")
        elif want[k] != got[k]:
            problems.append(f"{k}: shape {got[k]} != model's {want[k]}")
    if problems:
        raise ValueError(
            f"imported checkpoint does not fit the '{cfg.task}' model "
            f"config (check classes/som_k/surface_normal/feature_num/"
            f"output_*_pc_num):\n  " + "\n  ".join(problems))


def import_reference_checkpoint(cfg: Config,
                                files: Dict[str, str]) -> Dict[str, Tree]:
    """Reference ``.pth`` files -> ``{"params", "batch_stats"}`` trees
    for ``cfg``'s model, in the layout ``convert.load_jax_variables``
    loads.  ``files`` maps a sub-network's label to its path: ``encoder``
    and the task's head.  Raises ValueError, naming every leaf that does
    not fit, when the files are not of ``cfg``'s architecture."""
    head = _TASK_HEADS[cfg.task]
    missing = [n for n in ("encoder", head) if n not in files]
    if missing:
        raise ValueError(f"task '{cfg.task}' needs state_dicts for "
                         f"{['encoder', head]}; missing {missing}")
    extra = sorted(set(files) - {"encoder", head})
    if extra:
        raise ValueError(f"unexpected sub-networks {extra} for task "
                         f"'{cfg.task}' (want encoder + {head})")
    params, stats = {}, {}
    for label, path in files.items():
        p, s = _CONVERTERS[label](load_state_dict(path))
        params[label] = p
        if s:
            stats[label] = s
    variables = {"params": params, "batch_stats": stats}
    _check_against_model(cfg, variables)
    return variables


# ---------------------------------------------------------------------------
# tree -> reference state_dict
# ---------------------------------------------------------------------------

def _inv_bn(bn_p: Tree, bn_s: Tree, prefix: str) -> Dict[str, np.ndarray]:
    """BatchNorm leaves -> ``norm.*`` entries (the step counter written as
    0: momentum here is epoch-driven)."""
    return {f"{prefix}norm.weight": np.asarray(bn_p["scale"], np.float32),
            f"{prefix}norm.bias": np.asarray(bn_p["bias"], np.float32),
            f"{prefix}norm.running_mean": np.asarray(bn_s["mean"],
                                                     np.float32),
            f"{prefix}norm.running_var": np.asarray(bn_s["var"], np.float32),
            f"{prefix}norm.num_batches_tracked": np.asarray(0, np.int64)}


def _inv_point_layer(p: Tree, s: Optional[Tree], kind: str,
                     prefix: str) -> Dict[str, np.ndarray]:
    """The converse of ``_point_layer``; ``kind`` is the reference's
    layer: ``conv1d``, ``conv2d`` or ``linear``."""
    out = {}
    k = np.asarray(p["Dense_0"]["kernel"], np.float32)     # (Cin, Cout)
    b = np.asarray(p["Dense_0"]["bias"], np.float32)
    if kind == "conv1d":
        out[f"{prefix}conv.weight"] = np.ascontiguousarray(k.T[:, :, None])
        out[f"{prefix}conv.bias"] = b
    elif kind == "conv2d":
        out[f"{prefix}conv.weight"] = np.ascontiguousarray(
            k.T[:, :, None, None])
        out[f"{prefix}conv.bias"] = b
    else:
        out[f"{prefix}linear.weight"] = np.ascontiguousarray(k.T)
        out[f"{prefix}linear.bias"] = b
    if "BatchNorm_0" in p:
        out.update(_inv_bn(p["BatchNorm_0"], (s or {})["BatchNorm_0"],
                           prefix))
    return out


def _inv_stack(p: Tree, s: Optional[Tree], kind: str,
               prefix: str) -> Dict[str, np.ndarray]:
    out = {}
    for i in sorted(int(n.split("_")[1]) for n in p):
        name = f"PointLayer_{i}"
        out.update(_inv_point_layer(p[name], (s or {}).get(name), kind,
                                    f"{prefix}layers.{i}."))
    return out


def encoder_state_dict(params: Tree, stats: Tree) -> Dict[str, np.ndarray]:
    """The encoder's tree -> the reference module's state_dict arrays
    (without the dead ``transformer``: load with ``strict=False``)."""
    kinds = {"first_pointnet": "conv1d", "knnlayer": "conv2d",
             "final_pointnet": "conv1d"}
    out = {}
    for sub in ("first_pointnet", "knnlayer", "final_pointnet"):
        if sub in params:
            out.update(_inv_stack(params[sub], stats.get(sub), kinds[sub],
                                  f"{sub}."))
    return out


def classifier_state_dict(params: Tree, stats: Tree) -> Dict[str, np.ndarray]:
    out = {}
    for name in ("fc1", "fc2", "fc3"):
        out.update(_inv_point_layer(params[name], stats.get(name), "linear",
                                    f"{name}."))
    return out


def segmenter_state_dict(params: Tree, stats: Tree) -> Dict[str, np.ndarray]:
    out = {}
    for i in range(1, 6):
        out.update(_inv_point_layer(params[f"layer{i}"],
                                    stats.get(f"layer{i}"), "conv1d",
                                    f"layer{i}."))
    return out


def decoder_state_dict(params: Tree, stats: Tree) -> Dict[str, np.ndarray]:
    out = {}
    if "fc_decoder" in params:
        fp, fs = params["fc_decoder"], stats.get("fc_decoder", {})
        for i, name in enumerate(("linear1", "linear2", "linear3")):
            out.update(_inv_point_layer(fp[f"PointLayer_{i}"],
                                        fs.get(f"PointLayer_{i}"), "linear",
                                        f"fc_decoder.{name}."))
        out["fc_decoder.linear_out.linear.weight"] = np.ascontiguousarray(
            np.asarray(fp["linear_out"]["kernel"], np.float32).T)
        out["fc_decoder.linear_out.linear.bias"] = np.asarray(
            fp["linear_out"]["bias"], np.float32)
    if "conv_decoder" in params:
        cp, cs = params["conv_decoder"], stats.get("conv_decoder", {})
        for n in range(1, 7):
            up, us = cp[f"UpConv_{n - 1}"], cs.get(f"UpConv_{n - 1}", {})
            w = np.asarray(up["Conv_0"]["kernel"], np.float32)  # (3,3,Ci,Co)
            pre = f"conv_decoder.deconv{n}.conv."
            out[f"{pre}conv.weight"] = np.ascontiguousarray(
                w.transpose(3, 2, 0, 1))
            out[f"{pre}conv.bias"] = np.asarray(up["Conv_0"]["bias"],
                                                np.float32)
            out.update(_inv_bn(up["BatchNorm_0"], us["BatchNorm_0"], pre))
        for j in (4, 5, 6):
            tp = cp[f"ConvToPC_{j - 4}"]
            ts = cs.get(f"ConvToPC_{j - 4}", {})
            pre = f"conv_decoder.conv2pc{j}."
            out.update(_inv_point_layer(tp["PointLayer_0"],
                                        ts.get("PointLayer_0"), "conv2d",
                                        f"{pre}conv1."))
            k = np.asarray(tp["Dense_0"]["kernel"], np.float32)  # (Cin, 3)
            out[f"{pre}conv2.conv.weight"] = np.ascontiguousarray(
                k.T[:, :, None, None])
            out[f"{pre}conv2.conv.bias"] = np.asarray(tp["Dense_0"]["bias"],
                                                      np.float32)
    return out


_EXPORTERS = {"encoder": encoder_state_dict,
              "classifier": classifier_state_dict,
              "segmenter": segmenter_state_dict,
              "decoder": decoder_state_dict}


def _unflatten(flat: Dict[str, np.ndarray]) -> Tree:
    """{"a/b/c": array} -> a nested tree (the converse of
    ``convert.flatten``)."""
    tree: Tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def export_reference_checkpoint(run_dir: str, out_dir: Optional[str] = None,
                                checkpoint: Optional[str] = None
                                ) -> Dict[str, str]:
    """A run of the port -> ``<step>_net_<label>.pth`` files, one a
    sub-network, as the reference's ``save_network`` writes them, in
    ``out_dir`` (default ``run_dir/reference_export``).  ``checkpoint``
    defaults to the newest under ``run_dir/ckpt``.  Returns
    ``{label: path}``.  The weights are read on the CPU: nothing is
    computed."""
    from . import train
    from .models import build_model

    cfg = load_config(os.path.join(run_dir, "config.json"))
    ckpt = checkpoint or train.latest_checkpoint(os.path.join(run_dir,
                                                              "ckpt"))
    if ckpt is None:
        raise FileNotFoundError(f"no checkpoint found under {run_dir}/ckpt")
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    model = build_model(cfg.replace(mesh_shape=(1, 1)), device="cpu")
    model.load_state_dict(payload["model"], strict=True)
    tree = _unflatten(convert.to_jax_variables(model))
    step = int(payload["step"])

    out_dir = out_dir or os.path.join(run_dir, "reference_export")
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for label, p in tree["params"].items():
        arrays = _EXPORTERS[label](p, tree.get("batch_stats", {}).get(label,
                                                                     {}))
        sd = {k: torch.from_numpy(np.array(v, copy=True))
              for k, v in arrays.items()}
        path = os.path.join(out_dir, f"{step}_net_{label}.pth")
        torch.save(sd, path)
        paths[label] = path
    return paths


def import_run(cfg: Config, files: Dict[str, str], out_dir: str,
               step: int = 0, device: str | torch.device = "cuda") -> str:
    """Reference ``.pth`` files -> a run directory of the port:
    ``out_dir/config.json`` and ``out_dir/ckpt/step_<step>.pt``, as the
    ``Trainer`` writes them (a fresh optimizer at ``step``), with the
    state built on ``device``.  A config that does not fit the files
    fails before anything is written.  Returns the checkpoint's path."""
    from . import train

    variables = import_reference_checkpoint(cfg, files)
    state = train.init_state(cfg, device=device, seed=cfg.seed)
    convert.load_jax_variables(state.model, variables)
    # the payload's step must be the directory's: a later save at a step
    # below it would sort under it, and every resume would go back to it
    state.step = int(step)
    os.makedirs(out_dir, exist_ok=True)
    cfg.save(os.path.join(out_dir, "config.json"))
    return train.save_checkpoint(os.path.join(out_dir, "ckpt"), state, step)
