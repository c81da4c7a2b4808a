"""Interactive mesh preprocessor (the flow of
rdcfes_tpu.drivers.process_mesh; C++ reference src/process_mesh.C:86-172).

Prompts on stdin for a Gmsh input file, a scale, a translation and a
rotation, then writes the transformed mesh as Gmsh 2.2 ASCII (boundary
side elements first, with their boundary-condition ids), an ExodusII
`.ex2` copy (src/process_mesh.C:169, io/exodus.py: one element block per
type, so mixed and TET10 meshes export too) and a `.config` record of the
answers.  A failed ExodusII export prints a NOTE to stderr and the
driver goes on.  Node order is always kept (mesh/gmsh.py), so the
renumbering prompt is asked and its answer unused, as in the reference
package.
"""

from __future__ import annotations

import sys

from ..io.exodus import write_exodus
from ..mesh import gmsh, transform


def _ask(prompt: str) -> str:
    print(prompt, end="", flush=True)
    return input().strip()


def run() -> None:
    input_file = _ask("Give name of the Gmsh-formatted input file: ")
    print("\nFE mesh is now loading... ", end="", flush=True)
    mesh = gmsh.read(input_file)
    print(" ok")

    scale = float(_ask("Give value to scale nodes' coordinates: "))
    tx = float(_ask("Give value for mesh translation (X-axis): "))
    ty = float(_ask("Give value for mesh translation (Y-axis): "))
    tz = float(_ask("Give value for mesh translation (Z-axis): "))
    rx = float(_ask("Give value for mesh rotation (X-axis) in degrees: "))
    ry = float(_ask("Give value for mesh rotation (Y-axis) in degrees: "))
    rz = float(_ask("Give value for mesh rotation (Z-axis) in degrees: "))
    _ask("Skip node renumbering? True or false? Insert '1' or '0' "
         "respectively: ")

    print("\n" + mesh.print_info() + "\n")
    print("FE mesh is now under processing... ", end="", flush=True)
    mesh = transform.transform_mesh(mesh, scale=scale, translate=(tx, ty, tz),
                                    rotate_deg=(rx, ry, rz))
    print(" ok")

    out = _ask("Give name of the output files: ")
    print("Mesh and configuration data is now saving... ", end="",
          flush=True)
    gmsh.write(mesh, out + ".msh")
    try:
        write_exodus(out + ".ex2", mesh)
    except (OSError, ImportError, ValueError) as e:
        print(f"NOTE: ExodusII export skipped ({e})", file=sys.stderr)
    with open(out + ".config", "w") as f:
        f.write(f"Gmsh input: {input_file}\n")
        f.write(f"mesh scaling: {scale:g}\n")
        f.write(f"translation (X-axis): {tx:g}\n")
        f.write(f"translation (Y-axis): {ty:g}\n")
        f.write(f"translation (Z-axis): {tz:g}\n")
        f.write(f"rotation (X-axis) in degrees: {rx:g}\n")
        f.write(f"rotation (Y-axis) in degrees: {ry:g}\n")
        f.write(f"rotation (Z-axis) in degrees: {rz:g}\n")
        f.write(f"output file name: {out}\n")
    print(" ok")
