"""Evidence file loading for relational models (PyTorch port of
``lhvi_tpu/relational/data.py``, identical below this docstring).

Line format (``#`` comments, blank lines ignored)::

    smokes(anna) = 1
    friends(anna, bob) = 1
    stress(bob) = 0.73
    !cancer(chris)          # bang prefix = value 0 (MLN negation style)
    cancer(anna)            # bare atom = value 1

``load_evidence`` parses into the ``{(pred, args): value}`` mapping that
``RelationalGraph.observe_many`` consumes.
"""

from __future__ import annotations

import re
from typing import Dict, Tuple, Union

_ATOM = re.compile(
    r"^\s*(?P<neg>!)?\s*(?P<pred>\w+)\s*\(\s*(?P<args>[^)]*)\s*\)"
    r"\s*(?:=\s*(?P<val>[-+0-9.eE]+))?\s*$"
)


def parse_evidence_line(line: str):
    """Parse one line → ((pred, args), value) or None for blanks/comments."""
    line = line.split("#", 1)[0].strip()
    if not line:
        return None
    m = _ATOM.match(line)
    if not m:
        raise ValueError(f"cannot parse evidence line: {line!r}")
    args = tuple(a.strip() for a in m.group("args").split(",") if a.strip())
    if m.group("val") is not None:
        value = float(m.group("val"))
        if value.is_integer():
            value = int(value)
    else:
        value = 0 if m.group("neg") else 1
    if m.group("neg") and m.group("val") is not None:
        raise ValueError(f"both '!' and '=value' in: {line!r}")
    return (m.group("pred"), args), value


def load_evidence(path_or_text: Union[str, "os.PathLike"]) -> Dict[Tuple, object]:
    """Load an evidence file (or inline text containing newlines)."""
    text = str(path_or_text)
    if "\n" not in text:
        with open(text) as fh:
            text = fh.read()
    out: Dict[Tuple, object] = {}
    for line in text.splitlines():
        parsed = parse_evidence_line(line)
        if parsed:
            out[parsed[0]] = parsed[1]
    return out
