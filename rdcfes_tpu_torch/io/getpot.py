"""GetPot-compatible input-deck parser (copy of rdcfes_tpu.io.getpot: the
same values, the same consumed-key bookkeeping and the same warnings).

Syntax of the shipped decks (run/*/input.dat): `key = value` pairs with
'/'-hierarchical keys; `#` starts a comment (whole-line or trailing);
single- or double-quoted values (integer lists like BCs = ' 0 5 ',
filenames); booleans written true/false.  `deck(name, default)` converts
the stored string to the type of the default, as GetPot does.  Every
lookup is recorded, and `warn_unused()` reports the deck keys no driver
consumed: the C++ reference silently falls back to defaults on a
misspelled key (e.g. `taxis/A_b` for `taxis_1/A_b`, or the Solid decks'
`Neohookean` for `Hyperelastic`).
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence, Set, TextIO, Union


def export_integers(s: str) -> list:
    """Whitespace-separated integer extraction (src/utils.h:267-288):
    non-integer tokens are skipped; result sorted unique (std::set)."""
    out = set()
    for tok in s.split():
        try:
            out.add(int(tok))
        except ValueError:
            continue
    return sorted(out)


class Deck:
    def __init__(self, source: Union[str, TextIO, Dict[str, str]] = ""):
        self._values: Dict[str, str] = {}
        self._accessed: Set[str] = set()
        if isinstance(source, dict):
            self._values = {k: str(v) for k, v in source.items()}
        elif isinstance(source, str):
            if source:
                with open(source) as f:
                    self._parse(f.read())
        else:
            self._parse(source.read())

    # ------------------------------------------------------------------
    def _parse(self, text: str) -> None:
        for raw in text.splitlines():
            line = self._strip_comment(raw).strip()
            if not line or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key = key.strip()
            value = value.strip()
            if len(value) >= 2 and value[0] == "'" and value[-1] == "'":
                value = value[1:-1]
            elif len(value) >= 2 and value[0] == '"' and value[-1] == '"':
                value = value[1:-1]
            self._values[key] = value

    @staticmethod
    def _strip_comment(line: str) -> str:
        out = []
        in_quote: Optional[str] = None
        for ch in line:
            if in_quote:
                if ch == in_quote:
                    in_quote = None
                out.append(ch)
            elif ch in "'\"":
                in_quote = ch
                out.append(ch)
            elif ch == "#":
                break
            else:
                out.append(ch)
        return "".join(out)

    # ------------------------------------------------------------------
    def __call__(self, name: str, default):
        """GetPot-style typed lookup: convert to the type of `default`."""
        self._accessed.add(name)
        if name not in self._values:
            return default
        raw = self._values[name]
        if isinstance(default, bool):
            return raw.strip().lower() in ("true", "1", "yes", "on")
        if isinstance(default, int):
            try:
                return int(raw)
            except ValueError:
                return int(float(raw))
        if isinstance(default, float):
            return float(raw)
        return raw

    def have(self, name: str) -> bool:
        return name in self._values

    def keys(self) -> Sequence[str]:
        return list(self._values)

    # ------------------------------------------------------------------
    def unused_keys(self) -> Sequence[str]:
        return sorted(k for k in self._values if k not in self._accessed)

    def warn(self, msg: str, out: Optional[TextIO] = None) -> None:
        """Deck-layer warning channel: a consumed key whose requested
        behavior cannot be honored (same stream discipline as
        warn_unused — resolve the stream at call time)."""
        if out is None:
            out = sys.stderr
        print(f"WARNING: {msg}", file=out)

    def warn_unused(self, out: Optional[TextIO] = None) -> Sequence[str]:
        if out is None:
            # resolve at CALL time: a def-time `= sys.stderr` default
            # captures whatever stream was installed at import (pytest's
            # capture object, a redirected pipe) and writes to it after
            # it is closed
            out = sys.stderr
        unused = self.unused_keys()
        if unused:
            print(
                "WARNING: input deck keys never consumed (typo? the reference "
                "would silently use defaults):", file=out,
            )
            for k in unused:
                print(f"  {k} = {self._values[k]}", file=out)
        return unused
