"""Plain-ASCII table rendering (copy of the JAX package's ``ascii_table``)."""

from __future__ import annotations

from typing import Iterable, List, Sequence


def ascii_table(field_names: Sequence[str], rows: Iterable[Sequence]) -> str:
    """PrettyTable-style box table."""
    rows = [[str(c) for c in r] for r in rows]
    names = [str(n) for n in field_names]
    widths = [len(n) for n in names]
    for r in rows:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(c))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out: List[str] = [sep]
    out.append("|" + "|".join(f" {n:^{w}} " for n, w in zip(names, widths)) + "|")
    out.append(sep)
    for r in rows:
        out.append("|" + "|".join(f" {c:^{w}} " for c, w in zip(r, widths)) + "|")
    out.append(sep)
    return "\n".join(out)
