"""Reference (PyTorch) checkpoint <-> framework parameter conversion.

Lets a user of the reference repo bring their trained ``best_CER.pth`` /
``state_dict_ema`` weights into this framework (and export back). Covers the
flagship model_v1 layout (model_v1/model/HTR_VT.py + resnet18.py):

  torch name                              ours
  ------------------------------------------------------------------
  patch_embed.conv1.weight                stem/conv1/kernel      (OIHW->HWIO)
  patch_embed.bn1.{weight,bias}           stem/bn1/{scale,bias}
  patch_embed.bn1.running_{mean,var}      batch_stats stem/bn1/{mean,var}
  patch_embed.layerS.B.convK.weight       stem/stageS_block{B+1}/convK/kernel
  patch_embed.layerS.B.downsample.0/1     stem/stageS_block1/proj_conv|proj_bn
  mask_token                              mask_token
  blocks.I.norm{1,2}.{weight,bias}        blockI/norm{1,2}/{scale,bias}
  blocks.I.attn.{qkv,proj}.{weight,bias}  blockI/attn/{qkv,proj} (W transposed)
  blocks.I.mlp.fc{1,2}.{weight,bias}      blockI/mlp/fc{1,2}
  norm.{weight,bias}                      norm/{scale,bias}
  head.{weight,bias}                      head/
  pos_embed                               (fixed sin-cos; recomputed, ignored)

Works on plain numpy dicts so torch is only needed to torch.load the file.

The port's own copy of ``htr_vt_tpu/utils/torch_convert.py``, held to it
by ``tests/test_torch_stem_kernels.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))  # OIHW -> HWIO


def _conv_inv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (3, 2, 0, 1))


def _lin(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (1, 0))  # [out,in] -> [in,out]


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def reference_state_dict_to_tree(sd: Dict[str, np.ndarray]):
    """torch state_dict (numpy values; 'module.' prefixes tolerated like the
    reference loaders, model_v1/utils/utils.py:191-211) ->
    (params, batch_stats) pytrees for HTRVT."""
    params: Dict = {}
    stats: Dict = {}
    unused = []

    def bn(dst_parent: Tuple[str, ...], dst_name: str, src: str):
        _set(params, dst_parent + (dst_name, "scale"), sd[f"{src}.weight"])
        _set(params, dst_parent + (dst_name, "bias"), sd[f"{src}.bias"])
        _set(stats, dst_parent + (dst_name, "mean"), sd[f"{src}.running_mean"])
        _set(stats, dst_parent + (dst_name, "var"), sd[f"{src}.running_var"])

    sd = {k[len("module."):] if k.startswith("module.") else k: np.asarray(v)
          for k, v in sd.items()}

    for key in list(sd):
        if key == "pos_embed" or key.endswith("num_batches_tracked"):
            continue
        if key == "mask_token":
            _set(params, ("mask_token",), sd[key])
        elif key == "patch_embed.conv1.weight":
            _set(params, ("stem", "conv1", "kernel"), _conv(sd[key]))
        elif key.startswith("patch_embed.bn1."):
            pass  # handled below
        elif key.startswith("patch_embed.layer"):
            pass  # handled below
        elif key.startswith("blocks."):
            _, i, rest = key.split(".", 2)
            blk = f"block{i}"
            if rest.startswith("norm"):
                name, attr = rest.split(".")
                _set(params, (blk, name, "scale" if attr == "weight" else "bias"),
                     sd[key])
            elif rest.startswith("attn.") and rest.count(".") == 2:
                _, lin, attr = rest.split(".")
                val = _lin(sd[key]) if attr == "weight" else sd[key]
                _set(params, (blk, "attn", lin, "kernel" if attr == "weight" else "bias"), val)
            elif rest.startswith("mlp."):
                _, lin, attr = rest.split(".")
                val = _lin(sd[key]) if attr == "weight" else sd[key]
                _set(params, (blk, "mlp", lin, "kernel" if attr == "weight" else "bias"), val)
            else:
                unused.append(key)
        elif key.startswith("norm."):
            attr = key.split(".")[1]
            _set(params, ("norm", "scale" if attr == "weight" else "bias"), sd[key])
        elif key.startswith("head."):
            attr = key.split(".")[1]
            val = _lin(sd[key]) if attr == "weight" else sd[key]
            _set(params, ("head", "kernel" if attr == "weight" else "bias"), val)
        else:
            unused.append(key)

    bn(("stem",), "bn1", "patch_embed.bn1")
    for s in (1, 2, 3):
        for b in (0, 1):
            src = f"patch_embed.layer{s}.{b}"
            if f"{src}.conv1.weight" not in sd:
                continue
            dst = ("stem", f"stage{s}_block{b + 1}")
            _set(params, dst + ("conv1", "kernel"), _conv(sd[f"{src}.conv1.weight"]))
            _set(params, dst + ("conv2", "kernel"), _conv(sd[f"{src}.conv2.weight"]))
            bn(dst, "bn1", f"{src}.bn1")
            bn(dst, "bn2", f"{src}.bn2")
            if f"{src}.downsample.0.weight" in sd:
                _set(params, dst + ("proj_conv", "kernel"),
                     _conv(sd[f"{src}.downsample.0.weight"]))
                bn(dst, "proj_bn", f"{src}.downsample.1")

    return params, stats, unused


def tree_to_reference_state_dict(params, batch_stats) -> Dict[str, np.ndarray]:
    """Inverse mapping: export HTRVT weights in the reference's torch layout
    (enables checking parity in the original repo)."""
    sd: Dict[str, np.ndarray] = {}

    def put_bn(src_parent, name, dst):
        p = src_parent[name]
        s = _get_stats(batch_stats, src_parent_path + (name,))
        sd[f"{dst}.weight"] = np.asarray(p["scale"])
        sd[f"{dst}.bias"] = np.asarray(p["bias"])
        sd[f"{dst}.running_mean"] = np.asarray(s["mean"])
        sd[f"{dst}.running_var"] = np.asarray(s["var"])

    def _get_stats(tree, path):
        node = tree
        for k in path:
            node = node[k]
        return node

    stem = params["stem"]
    sd["patch_embed.conv1.weight"] = _conv_inv(np.asarray(stem["conv1"]["kernel"]))
    src_parent_path = ("stem",)
    put_bn(stem, "bn1", "patch_embed.bn1")
    for s in (1, 2, 3):
        for b in (0, 1):
            name = f"stage{s}_block{b + 1}"
            if name not in stem:
                continue
            blk = stem[name]
            src_parent_path = ("stem", name)
            dst = f"patch_embed.layer{s}.{b}"
            sd[f"{dst}.conv1.weight"] = _conv_inv(np.asarray(blk["conv1"]["kernel"]))
            sd[f"{dst}.conv2.weight"] = _conv_inv(np.asarray(blk["conv2"]["kernel"]))
            put_bn(blk, "bn1", f"{dst}.bn1")
            put_bn(blk, "bn2", f"{dst}.bn2")
            if "proj_conv" in blk:
                sd[f"{dst}.downsample.0.weight"] = _conv_inv(
                    np.asarray(blk["proj_conv"]["kernel"]))
                put_bn(blk, "proj_bn", f"{dst}.downsample.1")

    sd["mask_token"] = np.asarray(params["mask_token"])
    for key in params:
        if not key.startswith("block") or key == "mask_token":
            continue
        i = key[len("block"):]
        if not i.isdigit():
            continue
        blk = params[key]
        for name in ("norm1", "norm2"):
            sd[f"blocks.{i}.{name}.weight"] = np.asarray(blk[name]["scale"])
            sd[f"blocks.{i}.{name}.bias"] = np.asarray(blk[name]["bias"])
        for mod, subs in (("attn", ("qkv", "proj")), ("mlp", ("fc1", "fc2"))):
            for sub in subs:
                sd[f"blocks.{i}.{mod}.{sub}.weight"] = _lin(
                    np.asarray(blk[mod][sub]["kernel"]))
                sd[f"blocks.{i}.{mod}.{sub}.bias"] = np.asarray(blk[mod][sub]["bias"])
    sd["norm.weight"] = np.asarray(params["norm"]["scale"])
    sd["norm.bias"] = np.asarray(params["norm"]["bias"])
    sd["head.weight"] = _lin(np.asarray(params["head"]["kernel"]))
    sd["head.bias"] = np.asarray(params["head"]["bias"])
    return sd


def load_reference_checkpoint(path: str, key: str = "state_dict_ema"):
    """torch.load a reference .pth and return (params, batch_stats, unused).
    ``key``: 'state_dict_ema' (eval convention) or 'model'."""
    import torch
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt[key] if isinstance(ckpt, dict) and key in ckpt else ckpt
    sd = {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
          for k, v in sd.items()}
    return reference_state_dict_to_tree(sd)
