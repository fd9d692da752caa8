"""Flat YAML configs and CSV tables without yaml or pandas.

The JAX package reads its run configs with ``yaml.safe_load`` and its
``dataset.csv`` tables with ``pandas`` (``p_div_gnn_tpu/train/runner.py:22``,
``inference.py:17``, ``graphs/dataset.py:16``); the card's machine has
neither. This module reads what those calls read in this repo:

- a config is one flat map of ``key: value`` lines. Each plain value is
  typed by PyYAML's YAML 1.1 rules (``yes``/``no``/``on``/``off`` are bools,
  ``1e-3`` without a dot stays a string), quoted values are strings.
  Nesting, lists, flow collections, anchors, aliases, tags, block scalars,
  escapes in double quotes and the YAML 1.1 numbers and dates no config
  uses (``010``, ``0x1F``, ``0b101``, ``1:30``, ``2001-12-14``) raise
  ``ValueError``.
- a table is a ``dict`` of columns (name → list), in file order, typed per
  column as ``pandas.read_csv`` types them (int, float with NaN for an
  empty cell, bool, else str; floats parsed as its C parser parses them),
  and written as ``DataFrame.to_csv(index=False)`` writes them: floats by
  ``repr``, NaN as an empty field.
"""

from __future__ import annotations

import csv
import math
import re
from pathlib import Path
from typing import Any

# PyYAML's implicit resolvers (yaml/resolver.py), tried in its order, for
# the forms this reader types; the YAML 1.1 forms it does not emulate
# (octal, binary, hex, base 60, timestamps) are refused
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_UNSUPPORTED = re.compile(r"""^(?:[-+]?0[0-9bx_][0-9a-fA-F_]*
                          |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
                          |[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt \t].*)?
                          |=|<<)$""", re.X)
# a plain scalar starting with one of these is a collection, an anchor, an
# alias, a tag, a block scalar, a directive or reserved
_INDICATORS = set("[]{}&*!|>%@`,")


def _resolve_plain(text: str) -> Any:
    """The value ``yaml.safe_load`` gives a plain (unquoted) scalar."""
    if _UNSUPPORTED.match(text):
        raise ValueError(f"octal, binary, hex, base-60, timestamp and merge values are "
                         f"not supported: {text!r}")
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        if value.lstrip("+-") == ".inf":
            return -math.inf if value[0] == "-" else math.inf
        return math.nan if value == ".nan" else float(value)
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _NULL.match(text):
        return None
    return text


def _scalar(text: str, where: str) -> Any:
    """One scalar with its trailing comment: a quoted string or a plain
    value typed by ``_resolve_plain``."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        quote = text[0]
        end = 1
        while True:
            end = text.find(quote, end)
            if end < 0:
                raise ValueError(f"{where}: unterminated quoted string")
            if quote == "'" and text[end + 1 : end + 2] == "'":
                end += 2  # '' is an escaped quote
            else:
                break
        body = text[1:end]
        if quote == '"' and "\\" in body:
            raise ValueError(f"{where}: escapes in double-quoted strings are not supported")
        rest = text[end + 1 :].strip()
        if rest and not rest.startswith("#"):
            raise ValueError(f"{where}: text after a quoted string: {rest!r}")
        return body.replace("''", "'") if quote == "'" else body
    comment = re.search(r"(^|\s)#", text)
    if comment:
        text = text[: comment.start()].rstrip()
    if text[:1] in _INDICATORS or text[:2] in ("- ", "? ", ": ") or text in ("-", "?"):
        raise ValueError(
            f"{where}: only flat `key: value` maps are supported (no lists, flow "
            f"collections, anchors, aliases, tags or block scalars): {text!r}")
    if ": " in text or text.endswith(":"):
        raise ValueError(f"{where}: nested maps are not supported: {text!r}")
    return _resolve_plain(text)


def _split_key(line: str, where: str) -> tuple[str, str]:
    if line[:1] in ("'", '"'):
        quote = line[0]
        end = line.find(quote, 1)
        while end > 0 and quote == "'" and line[end + 1 : end + 2] == "'":
            end = line.find(quote, end + 2)
        if end < 0 or line[end + 1 : end + 2] != ":":
            raise ValueError(f"{where}: expected `key: value`")
        return line[: end + 1], line[end + 2 :]
    match = re.search(r":(\s|$)", line)
    if not match:
        raise ValueError(f"{where}: expected `key: value`, got {line!r}")
    return line[: match.start()], line[match.end() :]


def parse_config(text: str, source: str = "<config>") -> dict[Any, Any]:
    """A flat YAML map as ``yaml.safe_load`` reads it (an empty document
    gives ``{}``); anything but ``key: value`` lines, comments and a leading
    ``---`` raises ``ValueError``."""
    out: dict[Any, Any] = {}
    for number, raw in enumerate(text.splitlines(), 1):
        where = f"{source}:{number}"
        line = raw.rstrip()
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        if line[0] in (" ", "\t"):
            raise ValueError(f"{where}: nested (indented) entries are not supported")
        if line == "---" and not out:
            continue
        if line.startswith(("- ", "---", "...")) or line == "-":
            raise ValueError(f"{where}: lists and multiple documents are not supported")
        key_text, value_text = _split_key(line, where)
        key = _scalar(key_text, where)
        if not value_text.strip() or value_text.strip().startswith("#"):
            value = None
        else:
            value = _scalar(value_text, where)
        out[key] = value
    return out


def read_config(path: str | Path) -> dict[Any, Any]:
    """``parse_config`` of a file."""
    return parse_config(Path(path).read_text(), str(path))


# --- CSV tables -------------------------------------------------------------

# pandas.read_csv's default NA strings (pandas/_libs/parsers.pyx)
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
       "nan", "null"}
_CSV_INT = re.compile(r"^[+-]?[0-9]+$")
_CSV_FLOAT = re.compile(
    r"^[+-]?(?:[0-9]+\.?[0-9]*(?:[eE][+-]?[0-9]+)?|\.[0-9]+(?:[eE][+-]?[0-9]+)?"
    r"|inf|infinity)$", re.I)
_CSV_NUMBER = re.compile(r"^([+-]?)([0-9]*)(?:\.([0-9]*))?(?:[eE]([+-]?[0-9]+))?$")
_POW10 = [float(f"1e{k}") for k in range(309)]
_CSV_TRUE = {"True", "TRUE", "true"}
_CSV_FALSE = {"False", "FALSE", "false"}

Table = dict[str, list[Any]]


def _pandas_float(text: str) -> float:
    """The double ``pandas.read_csv`` parses from ``text`` (its default C
    parser, ``precise_xstrtod``): the first 17 digits, leading zeros
    included, accumulated in a double, then scaled by a power of ten. It can
    be one ulp from the correctly rounded value (it reads
    ``0.14408536849992318`` as ``0.1440853684999231``); matching it keeps
    the tables this port writes identical to the JAX package's."""
    m = _CSV_NUMBER.match(text)
    if m is None:
        return float(text)  # inf, infinity
    sign, whole, frac, exp = m.group(1), m.group(2), m.group(3) or "", m.group(4)
    number, exponent, n_digits = 0.0, 0, 0
    for d in whole:
        if n_digits < 17:
            number = number * 10.0 + int(d)
            n_digits += 1
        else:
            exponent += 1
    used = frac[: max(17 - n_digits, 0)]
    for d in used:
        number = number * 10.0 + int(d)
    exponent -= len(used)
    if sign == "-":
        number = -number
    if exp:
        exponent += int(exp)
    if exponent > 308:
        return math.copysign(math.inf, number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 * number if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _column(cells: list[str]) -> list[Any]:
    values = [c for c in cells if c not in _NA]
    has_na = len(values) < len(cells)
    if values and all(_CSV_INT.match(v) for v in values):
        cast = float if has_na else int
        return [math.nan if c in _NA else cast(int(c)) for c in cells]
    if values and all(_CSV_FLOAT.match(v) for v in values):
        return [math.nan if c in _NA else _pandas_float(c) for c in cells]
    if values and all(v in _CSV_TRUE | _CSV_FALSE for v in values):
        return [math.nan if c in _NA else c in _CSV_TRUE for c in cells]
    if not values:
        return [math.nan] * len(cells)
    return [math.nan if c in _NA else c for c in cells]


def read_csv(path: str | Path) -> Table:
    """The table ``pandas.read_csv(path)`` reads, as {column: values}."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    if not rows:
        raise ValueError(f"{path}: empty CSV file")
    header, body = rows[0], [r for r in rows[1:] if r]
    for i, row in enumerate(body, 2):
        if len(row) != len(header):
            raise ValueError(f"{path}:{i}: {len(row)} fields, header has {len(header)}")
    return {name: _column([row[j] for row in body]) for j, name in enumerate(header)}


def _cell(value: Any) -> str:
    if value is None:
        return ""
    if isinstance(value, (bool, str)) or type(value).__name__ == "bool_":
        return str(value)
    if isinstance(value, int) or (hasattr(value, "dtype") and value.dtype.kind in "iu"):
        return str(int(value))
    value = float(value)
    return "" if math.isnan(value) else repr(value)


def table_len(table: Table) -> int:
    """The number of rows."""
    return len(next(iter(table.values()), []))


def write_csv(path: str | Path, table: Table) -> None:
    """Write ``table`` as ``DataFrame(table).to_csv(path, index=False)``."""
    n = table_len(table)
    if any(len(col) != n for col in table.values()):
        raise ValueError("table columns differ in length")
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(list(table))
        for i in range(n):
            writer.writerow([_cell(col[i]) for col in table.values()])
