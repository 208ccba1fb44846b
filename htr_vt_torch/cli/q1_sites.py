"""Time Q1 at every site of the int8 forward on the card:
``python -m htr_vt_torch.cli.q1_sites [--tree DIR]``.

Runs ``chip_smoke.py:q1_case`` at each of ``chip_smoke.INT8_SITES`` (the
flagship's int8 stem at bs 128, stage 1 padded to 256): Q1 against its
float64 twin (bit-equal or it raises), its device time, im2col +
``torch._int_mm`` and the bound. Prints the card's name and power limit,
then one JSON object: each site's record and one forward's Q1 time (the
sites' times times their launches a forward) beside its summed bound.
``--tree`` (a checkout of another commit) imports that tree's
``chip_smoke.py`` and ``htr_vt_torch`` in place of this one's, and that
tree builds its own kernels, so running it parent, change, change, parent
on one card compares two commits' Q1 site by site. Any tree since Q1's port
(``chip_smoke.q1_case``) works.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree", default=None,
                   help="import chip_smoke and htr_vt_torch from this checkout")
    args = p.parse_args(argv)
    root = os.path.abspath(args.tree or os.path.join(os.path.dirname(__file__), "..", ".."))
    sys.path.insert(0, root)
    for name in [m for m in sys.modules if m.split(".")[0] == "htr_vt_torch"]:
        del sys.modules[name]
    import torch

    import chip_smoke as cs

    smi, _ = cs.phase_device()
    device = torch.device("cuda", 0)
    sites, forward_ms, forward_bound_ms = {}, 0.0, 0.0
    for i, (name, shape, cout, k, stride, padding, kind, out_dtype, n) in enumerate(
            cs.INT8_SITES):
        rec = cs.q1_case(name, shape, cout, k, stride, padding, kind, out_dtype, device,
                         cs.SEED + 300 + i)
        sites[name] = rec
        forward_ms += n * rec["ms"]
        forward_bound_ms += n * rec["bound_ms"]
    print(json.dumps({"tree": root, "device": smi, "forward_ms": forward_ms,
                      "forward_bound_ms": forward_bound_ms, "sites": sites}), flush=True)


if __name__ == "__main__":
    main()
