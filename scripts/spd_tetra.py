"""The SPD ``tetra`` scene in the Water-plastic Cornell box, as OBJ + MTL.

    python3 scripts/spd_tetra.py            # assets/scenes/spd-tetra8.{obj,mtl}
    python3 scripts/spd_tetra.py --level 3 --out /tmp/spd-tetra3

Eric Haines's Standard Procedural Databases ("A Proposal for Standard
Graphics Environments", IEEE CG&A 7(11), 1987;
github.com/erich666/StandardProceduralDatabases) define ``tetra`` as a
Sierpinski tetrahedron: recursion depth L (the size factor) replaces each
tetrahedron by the four half-size ones at its corners, 4^L tetrahedra of
4 triangles each.  The recursion fixes the geometry; nothing is random.

What is this scene's own and not SPD's (SPD lights with points and has its
own view, which the renderer does not model): the base tetrahedron's
corners ``SIZE * (+-1, +-1, +-1)`` with an even number of minus signs,
centred at ``CENTER``; one diffuse material; and around it the floor,
ceiling, three walls and area light of ``CornellBox-Water-plastic.obj``
(12 triangles, copied with their materials; the spheres and the water left
out), seen by the renderer's fixed camera.

The gasket shares its vertices (2 * 4^L + 2 of them, on an integer lattice
of step ``SIZE / 2^L``, in first-use order) and its 4 face normals, and
each face winds so that its geometric normal is its ``vn``, pointing out of
its tetrahedron.  numpy only; the output is a pure function of L.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVEL = 8
SIZE = 0.6
CENTER = (0.0, 0.8, 0.0)

# the base tetrahedron's corners (an even number of minus signs), and its
# faces as corner triples wound counter-clockwise seen from outside: face k
# leaves out corner k, so its outward normal is -CORNERS[k] / sqrt(3)
CORNERS = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], np.int64)
FACES = np.array([[1, 3, 2], [0, 2, 3], [0, 3, 1], [0, 1, 2]], np.int64)

# CornellBox-Water-plastic.obj's box shell: (group, vertices, normals, faces
# as (v, vn) 1-based within the group), copied from that file
BOX = (
    ("floor", ["1.0000 0.0000 -1.0400", "-0.9900 0.0000 -1.0400",
               "-1.0100 0.0000 0.9900", "1.0000 0.0000 0.9900"],
     ["0.0000 1.0000 -0.0000"], [((1, 1), (2, 1), (3, 1)), ((3, 1), (4, 1), (1, 1))]),
    ("ceiling", ["1.0000 1.5900 -1.0", "1.0000 1.5900 1.0", "-1.00 1.5900 1.0",
                 "-1.00 1.5900 -1.0"],
     ["0.0000 -1.0000 -0.0000"], [((1, 1), (2, 1), (3, 1)), ((3, 1), (4, 1), (1, 1))]),
    ("backWall", ["1.0 1.5900 -1.0", "-1.0 1.5900 -1.0", "-1.0 0.0000 -1.0",
                  "1.0 0.0000 -1.0"],
     ["0.0000 0.0000 1.0000"], [((1, 1), (2, 1), (3, 1)), ((3, 1), (4, 1), (1, 1))]),
    ("rightWall", ["1.0000 1.5900  1.0", "1.0000 1.5900 -1.0", "1.0000 0.0000 -1.0",
                   "1.0000 0.0000  1.0"],
     ["-1.0000 0.0000 -0.0000"], [((1, 1), (2, 1), (3, 1)), ((3, 1), (4, 1), (1, 1))]),
    ("leftWall", ["-1.00 1.5900 -1.0", "-1.00 1.5900  1.0", "-1.00 0.0000  1.0",
                  "-1.00 0.0000 -1.0"],
     ["1.0 0.0 0.0"] * 4, [((1, 1), (2, 2), (3, 3)), ((3, 3), (4, 4), (1, 1))]),
    ("light", ["0.2300 1.5800 -0.2200", "0.2300 1.5800 0.1600", "-0.2400 1.5800 0.1600",
               "-0.2400 1.5800 -0.2200"],
     ["0.0000 -1.0000 -0.0000"], [((1, 1), (2, 1), (3, 1)), ((3, 1), (4, 1), (1, 1))]),
)
BOX_TRIANGLES = sum(len(g[3]) for g in BOX)

MTL = """\
# The SPD tetra scene (scripts/spd_tetra.py): the box shell's materials of
# CornellBox-Water-plastic.mtl, and the gasket's diffuse material.

newmtl floor
    Kd 0.7250 0.7100 0.6800
    Ks 1.0 0.0 0.0

newmtl ceiling
    Kd 0.7250 0.7100 0.6800
    Ks 1.0 0.0 0.0

newmtl backWall
    Kd 0.7250 0.7100 0.6800
    Ks 1.0 0.0 0.0

newmtl rightWall
    Kd 0.161 0.133 0.427
    Ks 1.0 0.0 0.0

newmtl leftWall
    Kd 0.6300 0.0650 0.0500
    Ks 1.0 0.0 0.0

newmtl light
    Kd 0.7250 0.7100 0.6800
    Ks 1.0 0.0 0.0
    Ka 10 10 10

newmtl tetra
    Kd 0.725 0.71 0.68
    Ks 1 0 0
"""


def gasket(level: int):
    """The level-L gasket on its integer lattice -> (lattice (V, 3) int64,
    faces (4^(L+1), 3) 0-based vertex indices, face normal index (4^(L+1),)
    0..3).  Vertex k's position is CENTER + SIZE * lattice[k] / 2^L."""
    centres = np.zeros((1, 3), np.int64)
    for k in range(level):
        step = 1 << (level - k - 1)
        centres = (centres[:, None, :] + step * CORNERS[None]).reshape(-1, 3)
    corners = centres[:, None, :] + CORNERS[None]              # (4^L, 4, 3)
    corner_faces = corners[:, FACES]                           # (4^L, 4 faces, 3, 3)
    flat = corner_faces.reshape(-1, 3)
    # first-use order of the distinct lattice points
    uniq, first, inverse = np.unique(flat, axis=0, return_index=True, return_inverse=True)
    rank = np.empty(len(uniq), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(uniq))
    faces = rank[inverse.reshape(-1)].reshape(-1, 3)
    lattice = uniq[np.argsort(first, kind="stable")]
    normal = np.tile(np.arange(4), len(centres))
    return lattice, faces, normal


def positions(lattice: np.ndarray, level: int) -> np.ndarray:
    """Lattice points -> float64 positions (exact in 8 decimals: SIZE / 2^L
    = 3 / (5 * 2^(L+1)))."""
    return np.asarray(CENTER) + SIZE * lattice / float(1 << level)


def obj_text(level: int, mtllib: str) -> str:
    lattice, faces, normal = gasket(level)
    out = [f"# The SPD tetra database at size factor {level} in the Water-plastic Cornell box",
           "# (scripts/spd_tetra.py; Haines, IEEE CG&A 7(11), 1987).",
           f"mtllib {mtllib}", ""]
    nv = nn = 0
    for name, verts, norms, tris in BOX:
        out += [f"v  {v}" for v in verts] + [f"vn {n}" for n in norms]
        out += [f"g {name}", f"usemtl {name}"]
        out += ["f " + " ".join(f"{nv + a}//{nn + b}" for a, b in tri) for tri in tris]
        out.append("")
        nv += len(verts)
        nn += len(norms)
    p = positions(lattice, level)
    out += ["v  " + line for line in _rows(p)]
    n = -CORNERS / np.sqrt(3.0)
    out += ["vn " + line for line in _rows(n)]
    out += ["g tetra", "usemtl tetra"]
    vi = faces + nv + 1
    ni = normal + nn + 1
    out += [f"f {a}//{k} {b}//{k} {c}//{k}" for (a, b, c), k in zip(vi.tolist(), ni.tolist())]
    return "\n".join(out) + "\n"


def _rows(x: np.ndarray) -> list[str]:
    return [" ".join(f"{c:.8f}" for c in row) for row in x.tolist()]


def write(level: int, stem: str) -> tuple[str, str]:
    """Write ``<stem>.obj`` and ``<stem>.mtl`` -> their paths."""
    name = os.path.basename(stem)
    obj, mtl = stem + ".obj", stem + ".mtl"
    with open(obj, "w", newline="\n") as f:
        f.write(obj_text(level, name + ".mtl"))
    with open(mtl, "w", newline="\n") as f:
        f.write(MTL)
    return obj, mtl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--level", type=int, default=LEVEL)
    ap.add_argument("--out", default=None,
                    help="output stem (default assets/scenes/spd-tetra<level>)")
    args = ap.parse_args(argv)
    stem = args.out or os.path.join(ROOT, "assets", "scenes", f"spd-tetra{args.level}")
    for path in write(args.level, stem):
        print(path, os.path.getsize(path))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
