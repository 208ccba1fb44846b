"""Serving artifacts through ``torch.export`` (port of ``htr_vt_tpu/deploy.py``,
which writes StableHLO through ``jax.export``).

The serving computation, the eval-mode forward and the greedy CTC collapse
(``ops/decode.py``), is exported as one program a width bucket, with the
weights lifted into the program's state. Loading a bundle needs torch,
numpy and the op library (``ops/library.py``) only: no model code. On the
card the program holds the hand-written kernels as the custom ops
``htrvt::pool_bn_relu_fwd`` (K3f), ``htrvt::conv3x3_bn_relu_fwd`` (K4f),
``htrvt::flash_attention_fwd`` (K5f) and ``htrvt::conv_int8`` (Q1), where
the model's switches and widths take them, and launches them when it runs.

A program runs on the device it was exported on: one exported for ``cuda``
needs a card and holds its kernels; one exported for ``cpu`` holds their
plain twins' ops and runs anywhere torch does. An artifact is read back by
the torch release that wrote it.

    bundle/
      meta.json
      w0512.pt2         # program(image[B, H, 512, 1]) -> (ids, lengths)
      w1024.pt2
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from htr_vt_torch.ops import library as _library  # noqa: F401  registers htrvt::
from htr_vt_torch.ops.decode import collapse_ids, collapsed_texts, greedy_ids

META_NAME = "meta.json"
FORMAT_VERSION = 1


def artifact_name(width: int) -> str:
    return f"w{width:04d}.pt2"


class ServingFn(nn.Module):
    """``image [B, H, W, 1] float32 -> (collapsed ids [B, T] int32, lengths
    [B] int32)``: the model's eval forward, then the greedy CTC collapse on
    the device, so only [B, T] ids leave it."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = self.model(image, train=False)
        return collapse_ids(greedy_ids(logits))


def make_serving_fn(model: nn.Module) -> ServingFn:
    """The model closed into the serving program (``make_serving_fn``,
    ``deploy.py:43-57``)."""
    return ServingFn(model).eval()


def export_serving(model: nn.Module, batch_size: int,
                   img_size: Tuple[int, int]) -> torch.export.ExportedProgram:
    """``torch.export`` of the serving program at the fixed input
    [batch_size, H, W, 1] float32, on the model's device, under
    ``torch.no_grad()``. An int8 model's calibrated scales and its
    quantized weights go into the program (``ops/quant.py:weight_cache``)."""
    device = next(model.parameters()).device
    example = torch.ones((batch_size, *img_size, 1), dtype=torch.float32,
                         device=device)
    with torch.no_grad(), warnings.catch_warnings():
        # The models cache per-grid tables (the position table, Swin's and
        # SVTR's windows) as plain attributes; the trace fills the cache,
        # export lifts the table into the program as a constant and puts
        # the attribute back, and warns that it was assigned.
        warnings.filterwarnings("ignore", message=".*was assigned during export")
        return torch.export.export(make_serving_fn(model), (example,))


def save_bundle(out_dir: str, programs: Dict[int, torch.export.ExportedProgram],
                meta: dict) -> int:
    """Write ``meta.json`` (``meta`` plus ``format_version`` and ``widths``)
    and one ``wNNNN.pt2`` a width; returns the bundle's bytes."""
    os.makedirs(out_dir, exist_ok=True)
    meta = dict(meta, format_version=FORMAT_VERSION, widths=sorted(programs))
    with open(os.path.join(out_dir, META_NAME), "w") as f:
        json.dump(meta, f, indent=1)
    total = 0
    for width, program in programs.items():
        path = os.path.join(out_dir, artifact_name(width))
        torch.export.save(program, path)
        total += os.path.getsize(path)
    return total


class ServingBundle:
    """A loaded bundle. Needs torch, numpy, the op library and the charset
    in meta.json: no model code of this package. A bundle exported for
    ``cuda`` raises on a machine with no card; it is never moved to the
    CPU."""

    def __init__(self, out_dir: str):
        with open(os.path.join(out_dir, META_NAME)) as f:
            self.meta = json.load(f)
        if self.meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"bundle format {self.meta.get('format_version')!r} != "
                f"supported {FORMAT_VERSION}")
        self.device = torch.device(self.meta.get("device", "cpu"))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{out_dir} was exported for {self.device} and holds the CUDA "
                "kernels; this machine has no CUDA device. Export the bundle "
                "again with --device cpu to serve on the CPU")
        self.batch_size: int = self.meta["batch_size"]
        self.height: int = self.meta["height"]
        self.charset: List[str] = self.meta["charset"]
        self._fns = {}
        for width in self.meta["widths"]:
            program = torch.export.load(os.path.join(out_dir, artifact_name(width)))
            self._fns[width] = program.module()

    @property
    def widths(self) -> List[int]:
        return sorted(self._fns)

    def run(self, images, width: Optional[int] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
        """[B, H, W, 1] float32 (numpy or a tensor) -> (ids [B, T], lengths
        [B]) numpy."""
        width = images.shape[2] if width is None else width
        if width not in self._fns:
            raise KeyError(f"no artifact for width {width}; have {self.widths}")
        x = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        with torch.no_grad():
            ids, lengths = self._fns[width](x)
        return ids.cpu().numpy(), lengths.cpu().numpy()

    def decode(self, ids: np.ndarray, lengths: np.ndarray) -> List[str]:
        # charset[0] is the blank; the ids are already collapsed in-program.
        return collapsed_texts(ids, lengths, self.charset)

    def transcribe(self, images: np.ndarray) -> List[str]:
        """Pad the batch to the bundle's batch size with white (ones) rows,
        run, decode, drop the padding."""
        b = images.shape[0]
        bs = self.batch_size
        out: List[str] = []
        for lo in range(0, b, bs):
            chunk = images[lo:lo + bs]
            if chunk.shape[0] < bs:
                pad = np.ones((bs - chunk.shape[0], *chunk.shape[1:]), chunk.dtype)
                chunk = np.concatenate([chunk, pad], axis=0)
            ids, lengths = self.run(chunk)
            out.extend(self.decode(ids, lengths)[:min(bs, b - lo)])
        return out
