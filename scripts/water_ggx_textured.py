"""The Water box with rough copper, rough plastic, frosted water and two
albedo maps, as OBJ + MTL + two PNGs.

    python3 scripts/water_ggx_textured.py     # assets/scenes/water-ggx-textured.*
    python3 scripts/water_ggx_textured.py --out /tmp/box --size 64

Written from the reference app's default scene, ``CornellBox-Water-plastic``
(serhii-rieznik/metal-renderer, renderer/Media/; the Williams College data,
public domain), with the app's material encoding ``Ks = (roughness,
metalness, +-ior)`` (renderer/Renderer.mm:286-295) set to the three rough
types the app declares and leaves as TODO (:305, :315, :319), and with the
texcoords the app parses and comments out (:365-369) on the two textured
surfaces:

    rightSphere  rough conductor  Ks 0.3 1.0 0.0, Kd copper's F0
    leftSphere   rough plastic    Ks 0.5 0.0 -1.5
    water        rough dielectric Ks 0.2 0.0 1.33333
    floor        rough plastic    Ks 0.4 0.0 -1.5, Kd 1, map_Kd: 32 x 32 tiles
    backWall     diffuse          Kd 1, map_Kd: a 16 x 16 checker

Copper's F0 (0.955, 0.638, 0.538) is Hoffman's ("Physics and Math of
Shading", SIGGRAPH 2015 course; Real-Time Rendering 4th ed., Table 9.2).
Everything else is the source's: its geometry, its other materials and the
leftover keys of the ones above.  The floor's and back wall's corners take
texcoords 0 or 2 along their two axes, so each map wraps twice; every other
face keeps no texcoord.  The maps are 8-bit RGB PNGs of ``--size`` squared
texels (2048 by default, the common size of a production albedo map), both
of one size.  numpy and the standard library only; the output is a pure
function of the source files and ``--size``.
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(ROOT, "assets", "scenes")
SOURCE = "CornellBox-Water-plastic"
NAME = "water-ggx-textured"
SIZE = 2048

# material -> the MTL keys set here; every other key as in the source
MATERIALS = {
    "rightSphere": {"Kd": "0.955 0.638 0.538", "Ks": "0.3 1.0 0.0"},
    "leftSphere": {"Ks": "0.5 0.0 -1.5"},
    "water": {"Ks": "0.2 0.0 1.33333"},
    "floor": {"Kd": "1.0 1.0 1.0", "Ks": "0.4 0.0 -1.5", "map_Kd": "{name}-floor.png"},
    "backWall": {"Kd": "1.0 1.0 1.0", "map_Kd": "{name}-wall.png"},
}
# the textured groups -> which of a corner's two texcoords are 2 (else 0):
# u along +x on both, v toward the back wall on the floor and up the wall
TEXCOORDS = {"floor": lambda x, y, z: (x > 0.0, z < 0.0),
             "backWall": lambda x, y, z: (x > 0.0, y > 0.8)}
# map -> (squares across, the two sRGB colours)
MAPS = {"wall": (16, ((232, 226, 212), (64, 74, 96))),
        "floor": (32, ((186, 98, 66), (226, 202, 160)))}


def checker(size: int, squares: int, colours) -> np.ndarray:
    """A ``size`` x ``size`` RGB checker of ``squares`` squares a side ->
    (size, size, 3) uint8."""
    cell = np.arange(size) * squares // size
    odd = (cell[:, None] + cell[None, :]) % 2
    return np.asarray(colours, np.uint8)[odd]


def png_bytes(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> an 8-bit RGB, non-interlaced PNG (filter 0 on
    every row, zlib level 9)."""
    h, w, _ = img.shape
    raw = b"".join(b"\0" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


def mtl_text(source: str, name: str = NAME) -> str:
    """The source MTL with the materials of ``MATERIALS`` rewritten, the
    maps named after ``name``: a key set here replaces the source's line of
    that key, or follows the block."""
    out = [f"# {name}: {SOURCE}.mtl with GGX types and map_Kd textures",
           "# (scripts/water_ggx_textured.py).", "#"]
    material, pending = None, {}

    def flush():
        out.extend(f"    {k} {v}" for k, v in pending.items())

    for line in source.splitlines():
        parts = line.split()
        if parts and parts[0] == "newmtl":
            flush()
            material = parts[1]
            pending = {k: v.format(name=name) for k, v in MATERIALS.get(material, {}).items()}
        elif parts and material is not None and parts[0] in pending:
            line = f"    {parts[0]} {pending.pop(parts[0])}"
        elif not parts and pending:
            flush()
            pending = {}
        out.append(line)
    flush()
    return "\n".join(out) + "\n"


def obj_text(source: str, name: str = NAME) -> str:
    """The source OBJ with its mtllib ``name``.mtl, its texcoords dropped,
    and four new ones a textured group, before its faces."""
    out = [f"# {name}: {SOURCE}.obj with texcoords on the floor and back wall",
           "# (scripts/water_ggx_textured.py)."]
    verts, group, vt, corner_vt = [], None, 0, {}
    for line in source.splitlines():
        parts = line.split()
        key = parts[0] if parts else ""
        if key == "mtllib":
            line = f"mtllib {name}.mtl"
        elif key == "vt" or line.strip().endswith("texture coords"):
            continue
        elif key == "v":
            verts.append(tuple(float(x) for x in parts[1:4]))
        elif key == "g":
            group = parts[1]
            if group in TEXCOORDS:
                # the group's 4 vertices are the last 4 read
                for k in range(len(verts) - 4, len(verts)):
                    u, v = (2.0 * far for far in TEXCOORDS[group](*verts[k]))
                    out.append(f"vt {u:.4f} {v:.4f}")
                    vt += 1
                    corner_vt[k] = vt
        elif key == "f":
            corners = []
            for token in parts[1:]:
                v, _, n = token.split("/")
                t = corner_vt.get(int(v) - 1, "") if group in TEXCOORDS else ""
                corners.append(f"{v}/{t}/{n}")
            line = "f " + " ".join(corners)
        out.append(line)
    return "\n".join(out) + "\n"


def write(stem: str, size: int = SIZE) -> list[str]:
    """Write ``<stem>.obj``, ``<stem>.mtl``, ``<stem>-wall.png`` and
    ``<stem>-floor.png`` -> their paths."""
    paths = []
    for ext, make in (("obj", obj_text), ("mtl", mtl_text)):
        with open(os.path.join(SCENES, f"{SOURCE}.{ext}")) as f:
            text = make(f.read(), os.path.basename(stem))
        paths.append(f"{stem}.{ext}")
        with open(paths[-1], "w", newline="\n") as f:
            f.write(text)
    for which, (squares, colours) in MAPS.items():
        paths.append(f"{stem}-{which}.png")
        with open(paths[-1], "wb") as f:
            f.write(png_bytes(checker(size, squares, colours)))
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=os.path.join(SCENES, NAME),
                    help="output stem (default assets/scenes/water-ggx-textured)")
    ap.add_argument("--size", type=int, default=SIZE, help="the maps' texels a side")
    args = ap.parse_args(argv)
    for path in write(args.out, args.size):
        print(path, os.path.getsize(path))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
