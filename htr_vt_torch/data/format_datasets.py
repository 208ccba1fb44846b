"""Offline dataset preparation (port of ``htr_vt_tpu/data/format_datasets.py``):
raw archives -> flat ``lines/`` directory of ``name.png`` + ``name.txt`` pairs
indexed by ``.ln`` list files.

Covers the reference's formatter (data/format_datasets.py): IAM (:45-157,
lines.tgz + xml/*.xml ground truth), READ2016 (:160-252, PAGE-XML line
polygons cropped from page images), the txt-sidecar writer that strips the
IAM '¬' marker (:255-266), and directory flattening (:269-297).

Run: ``python -m htr_vt_torch.data.format_datasets iam --archive lines.tgz
--xml-dir xml/ --out data/iam/lines`` (and ``read2016`` analogously). PIL and
cv2 are imported only by the READ2016 cropper, which reads page images.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tarfile
import xml.etree.ElementTree as ET
from typing import Dict, Iterable, List, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# IAM
# ---------------------------------------------------------------------------
def parse_iam_xml(xml_path: str) -> Dict[str, str]:
    """Form XML -> {line_id: text}. IAM encodes the text in each <line> tag's
    ``text`` attribute with XML entities."""
    root = ET.parse(xml_path).getroot()
    out = {}
    for line in root.iter("line"):
        lid = line.get("id")
        txt = line.get("text") or ""
        if lid:
            out[lid] = txt
    return out


def format_iam(archive: str, xml_dir: str, out_dir: str,
               strip_marker: bool = True) -> int:
    """Extract IAM lines.tgz, join with XML ground truth, emit png+txt pairs.
    Returns the number of lines written."""
    os.makedirs(out_dir, exist_ok=True)
    texts: Dict[str, str] = {}
    for name in sorted(os.listdir(xml_dir)):
        if name.endswith(".xml"):
            texts.update(parse_iam_xml(os.path.join(xml_dir, name)))

    count = 0
    with tarfile.open(archive, "r:*") as tar:
        for member in tar:
            if not member.isfile() or not member.name.endswith(".png"):
                continue
            lid = os.path.splitext(os.path.basename(member.name))[0]
            if lid not in texts:
                continue
            src = tar.extractfile(member)
            dst_png = os.path.join(out_dir, lid + ".png")
            with open(dst_png, "wb") as f:
                shutil.copyfileobj(src, f)
            write_label(os.path.join(out_dir, lid + ".txt"), texts[lid],
                        strip_marker=strip_marker)
            count += 1
    return count


def write_label(path: str, text: str, strip_marker: bool = True) -> None:
    """Write the txt sidecar; the reference's pkl2txt strips the '¬'
    crossed-out marker (data/format_datasets.py:255-266)."""
    if strip_marker:
        text = text.replace("¬", "")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)


# ---------------------------------------------------------------------------
# READ2016 (PAGE-XML)
# ---------------------------------------------------------------------------
_PAGE_NS = "{http://schema.primaresearch.org/PAGE/gts/pagecontent/2013-07-15}"


def parse_page_xml(xml_path: str) -> List[Tuple[str, np.ndarray, str]]:
    """PAGE-XML -> [(line_id, polygon Nx2, text)]."""
    root = ET.parse(xml_path).getroot()
    out = []
    for line in root.iter(f"{_PAGE_NS}TextLine"):
        lid = line.get("id") or ""
        coords = line.find(f"{_PAGE_NS}Coords")
        if coords is None:
            continue
        pts = coords.get("points", "")
        try:
            poly = np.array([[int(v) for v in p.split(",")] for p in pts.split()],
                            np.int64)
        except ValueError:
            continue
        text = ""
        te = line.find(f"{_PAGE_NS}TextEquiv")
        if te is not None:
            uni = te.find(f"{_PAGE_NS}Unicode")
            if uni is not None and uni.text:
                text = uni.text
        if len(poly) >= 3 and text:
            out.append((lid, poly, text))
    return out


def crop_line(page: np.ndarray, polygon: np.ndarray,
              background: int = 255) -> np.ndarray:
    """Crop the polygon bounding box, whiting out pixels outside the polygon
    (the reference crops PAGE polygons from page scans, :160-252)."""
    import cv2
    x0, y0 = polygon.min(axis=0)
    x1, y1 = polygon.max(axis=0)
    x0, y0 = max(0, x0), max(0, y0)
    crop = page[y0:y1 + 1, x0:x1 + 1].copy()
    mask = np.zeros(crop.shape[:2], np.uint8)
    cv2.fillPoly(mask, [polygon - [x0, y0]], 1)
    crop[mask == 0] = background
    return crop


def format_read2016(pages_dir: str, xml_dir: str, out_dir: str) -> int:
    """Crop every PAGE-XML text line from its page image. Returns count."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(xml_dir)):
        if not name.endswith(".xml"):
            continue
        stem = os.path.splitext(name)[0]
        page_path = None
        for ext in (".JPG", ".jpg", ".png", ".tif"):
            cand = os.path.join(pages_dir, stem + ext)
            if os.path.exists(cand):
                page_path = cand
                break
        if page_path is None:
            continue
        page = np.array(Image.open(page_path).convert("L"))
        for lid, poly, text in parse_page_xml(os.path.join(xml_dir, name)):
            crop = crop_line(page, poly)
            out_name = f"{stem}_{lid}"
            Image.fromarray(crop).save(os.path.join(out_dir, out_name + ".png"))
            write_label(os.path.join(out_dir, out_name + ".txt"), text)
            count += 1
    return count


# ---------------------------------------------------------------------------
# Flattening + list generation
# ---------------------------------------------------------------------------
def flatten_directory(root: str) -> None:
    """Move all files from nested subdirectories up into ``root`` and remove
    the empty directories (reference move_files_and_delete_folders, :269-297)."""
    for dirpath, _, filenames in os.walk(root, topdown=False):
        if dirpath == root:
            continue
        for fn in filenames:
            shutil.move(os.path.join(dirpath, fn), os.path.join(root, fn))
        os.rmdir(dirpath)


def write_list_file(out_path: str, names: Iterable[str]) -> None:
    with open(out_path, "w") as f:
        for n in names:
            f.write(n + "\n")


def main() -> None:
    p = argparse.ArgumentParser(description="htr_vt_torch dataset formatter")
    sub = p.add_subparsers(dest="cmd", required=True)
    iam = sub.add_parser("iam")
    iam.add_argument("--archive", required=True, help="lines.tgz")
    iam.add_argument("--xml-dir", required=True)
    iam.add_argument("--out", required=True)
    read = sub.add_parser("read2016")
    read.add_argument("--pages-dir", required=True)
    read.add_argument("--xml-dir", required=True)
    read.add_argument("--out", required=True)
    flat = sub.add_parser("flatten")
    flat.add_argument("--root", required=True)
    args = p.parse_args()
    if args.cmd == "iam":
        n = format_iam(args.archive, args.xml_dir, args.out)
    elif args.cmd == "read2016":
        n = format_read2016(args.pages_dir, args.xml_dir, args.out)
    else:
        flatten_directory(args.root)
        n = 0
    print(f"wrote {n} lines")


if __name__ == "__main__":
    main()
