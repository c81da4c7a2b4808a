"""Command-line entry point, with the dispatch of the C++ reference's
main.C (src/main.C:17-57) and of rdcfes_tpu.cli:

  python -m rdcfes_tpu_torch.cli -m {pihna|adpm}
  python -m rdcfes_tpu_torch.cli -s

Each driver reads `input.dat` from the working directory and runs on the
CUDA card.  `-m proteas`, `-m ripf`, `-c hcc` and `-u process_mesh` are
not ported yet and raise NotImplementedError naming their ROADMAP item;
anything else returns 1.
"""

from __future__ import annotations

import sys

_UNPORTED = {
    ("-m", "proteas"): "ROADMAP queue 1 item 10 (PROTEAS)",
    ("-m", "ripf"): "ROADMAP queue 1 item 10 (RIPF)",
    ("-c", "hcc"): "ROADMAP queue 1 item 12 (coupled HCC)",
    ("-u", "process_mesh"): "ROADMAP queue 1 item 16 (process_mesh)",
}


def main(argv=None, device=None) -> int:
    """Dispatch `argv` (default: sys.argv[1:]) to a driver; returns the
    exit code.  device None is the CUDA card."""
    argv = list(sys.argv[1:] if argv is None else argv)

    input_file = "input.dat"
    for a in argv:
        if a.startswith("input="):
            input_file = a.split("=", 1)[1]
    print(f"\n ** Input file is: {input_file}\n"
          "    Use 'input=<file>' to specify a different input file.\n")

    def next_after(flag):
        i = argv.index(flag)
        return argv[i + 1] if i + 1 < len(argv) else ""

    from . import drivers

    for flag in ("-m", "-s", "-c", "-u"):
        if flag in argv:
            break
    else:
        return 1
    if flag == "-s":
        drivers.solid.run(device=device)
        return 0
    choice = next_after(flag)
    if (flag, choice) in _UNPORTED:
        raise NotImplementedError(
            f"{flag} {choice}: {_UNPORTED[(flag, choice)]}")
    if (flag, choice) == ("-m", "pihna"):
        drivers.pihna.run(device=device)
    elif (flag, choice) == ("-m", "adpm"):
        drivers.adpm.run(device=device)
    else:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
