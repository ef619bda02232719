"""YAML configs with ``includes:`` inheritance and dotted overrides.

Counterpart of ``equiformer_tpu.utils.config`` that needs no PyYAML: it
carries its own reader (``loads``) for the subset of YAML that the repo's
``configs/**/*.yml`` use, with PyYAML's ``safe_load`` results on it:

* block mappings, nested by indentation, and block sequences (``- item``,
  also at the indentation of their key);
* flow sequences (``[64, 64]``), nested;
* plain scalars, resolved by YAML 1.1's rules as PyYAML resolves them:
  null (``~``, ``null``, empty), booleans (``true`` / ``false`` / ``yes`` /
  ``no`` / ``on`` / ``off`` in their three cases), decimal integers, floats
  (``5.0e-4``; ``1e-3``, without a dot, stays a string, as in PyYAML),
  ``.inf`` / ``.nan``, else strings;
* comments, whole-line or after a blank.

Anything outside the subset raises ``YAMLSubsetError``: quotes, flow
mappings (any ``{`` or ``}``), anchors, aliases, tags, block scalars
(``|``, ``>``), multi-line plain scalars, several documents, tabs in
indentation, complex keys, mappings inside block sequence items, and the
plain scalars PyYAML would read as octal, hexadecimal, binary,
sexagesimal or timestamp values.  Later files override earlier ones;
overrides ``a.b.c=value`` apply last, their values read by the same rules.
"""

from __future__ import annotations

import copy
import itertools
import os
import re
from typing import Any, Dict, List, Sequence, Tuple


class YAMLSubsetError(ValueError):
    """The text is not in the YAML subset that ``loads`` reads."""


_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True, "TRUE": True,
         "on": True, "On": True, "ON": True, "no": False, "No": False, "NO": False,
         "false": False, "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# the starts of PyYAML's other implicit numbers and timestamps: a leading 0
# before a digit, 'b', 'x' or '_', digits before ':', or a year before '-'
_OTHER_NUMBER = re.compile(r"^[-+]?(?:0[0-9bx_]|[0-9][0-9_]*:|[0-9]{4}-[0-9])")
_INDICATORS = "&*!|>%@`"


def _resolve(text: str) -> Any:
    """A plain scalar's value, by PyYAML's implicit resolvers."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * float(v)
    if _OTHER_NUMBER.match(text) or text in ("=", "<<"):
        raise YAMLSubsetError(f"scalar {text!r} is outside the subset")
    return text


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a '#' at the start or after a blank."""
    for i, c in enumerate(line):
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Flow:
    """Reader of one line's inline node: a flow sequence or a plain scalar."""

    def __init__(self, text: str):
        self.s, self.p = text, 0

    def _ws(self):
        while self.p < len(self.s) and self.s[self.p] == " ":
            self.p += 1

    def _peek(self) -> str:
        return self.s[self.p] if self.p < len(self.s) else ""

    def node(self, flow: bool) -> Any:
        self._ws()
        c = self._peek()
        if c == "[":
            return self._seq()
        if c and c in _INDICATORS:
            raise YAMLSubsetError(f"indicator {c!r} in {self.s!r} is outside the subset")
        if c == "?" and self.s[self.p + 1 : self.p + 2] in (" ", ""):
            raise YAMLSubsetError(f"complex key in {self.s!r}")
        return self._plain(flow)

    def _plain(self, flow: bool) -> Any:
        start = self.p
        while self.p < len(self.s):
            c = self.s[self.p]
            nxt = self.s[self.p + 1 : self.p + 2]
            if flow and c in ",[]":
                break
            if c == ":" and (nxt in (" ", "") or (flow and nxt in ",[]")):
                break
            self.p += 1
        return _resolve(self.s[start : self.p].strip())

    def _seq(self) -> List[Any]:
        self.p += 1
        out = []
        while True:
            self._ws()
            if self._peek() == "]":
                self.p += 1
                return out
            out.append(self.node(True))
            self._ws()
            c = self._peek()
            if c == ",":
                self.p += 1
            elif c == ":":
                raise YAMLSubsetError(f"a mapping inside a flow sequence in {self.s!r}")
            elif c != "]":
                raise YAMLSubsetError(f"expected ',' or ']' in {self.s!r}")

    def whole(self) -> Any:
        v = self.node(False)
        self._ws()
        if self.p != len(self.s):
            raise YAMLSubsetError(f"unexpected text after the value in {self.s!r}")
        return v


def _key_split(content: str):
    """(key, rest) of a block mapping entry ``key: rest``, or None."""
    if content[0] == "?" and content[1:2] in (" ", ""):
        raise YAMLSubsetError(f"complex key in {content!r}")
    if content[0] == "[":
        return None
    m = re.search(r":( |$)", content)
    if m is None:
        return None
    return _resolve(content[: m.start()].strip()), content[m.end() :].strip()


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _lines(text: str) -> List[Tuple[int, int, str]]:
    out = []
    for no, raw in enumerate(text.split("\n"), 1):
        raw = raw.rstrip("\r")
        lead = raw[: len(raw) - len(raw.lstrip(" \t"))]
        if "\t" in lead and raw.strip():
            raise YAMLSubsetError(f"line {no}: tab in the indentation")
        content = _strip_comment(raw).rstrip()
        if not content.strip():
            continue
        stripped = content.strip()
        if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
            raise YAMLSubsetError(f"line {no}: document markers are outside the subset")
        if any(c in stripped for c in "'\"{}"):
            raise YAMLSubsetError(f"line {no}: quotes and flow mappings are outside the "
                                  "subset")
        out.append((no, len(content) - len(content.lstrip(" ")), stripped))
    return out


def _block(lines, i: int, indent: int):
    content = lines[i][2]
    if _is_item(content):
        return _sequence(lines, i, indent)
    if _key_split(content) is not None:
        return _mapping(lines, i, indent)
    value = _Flow(content).whole()
    if i + 1 < len(lines) and lines[i + 1][1] >= indent:
        raise YAMLSubsetError(f"line {lines[i + 1][0]}: multi-line scalars are outside the "
                              "subset")
    return value, i + 1


def _child(lines, i: int, indent: int):
    """The value of an entry whose text ended at its ':' or '-', at line i."""
    if i < len(lines) and (lines[i][1] > indent
                           or (lines[i][1] == indent and _is_item(lines[i][2]))):
        return _block(lines, i, lines[i][1])
    return None, i


def _mapping(lines, i: int, indent: int):
    out: Dict[Any, Any] = {}
    while i < len(lines) and lines[i][1] >= indent:
        no, ind, content = lines[i]
        if ind > indent:
            raise YAMLSubsetError(f"line {no}: unexpected indentation")
        kv = _key_split(content)
        if kv is None:
            if _is_item(content):
                break
            raise YAMLSubsetError(f"line {no}: expected 'key: value'")
        key, rest = kv
        i += 1
        if rest:
            out[key] = _Flow(rest).whole()
            if i < len(lines) and lines[i][1] > indent:
                raise YAMLSubsetError(f"line {lines[i][0]}: multi-line values are outside "
                                      "the subset")
        else:
            out[key], i = _child(lines, i, indent)
    return out, i


def _sequence(lines, i: int, indent: int):
    out: List[Any] = []
    while i < len(lines) and lines[i][1] == indent and _is_item(lines[i][2]):
        no, _, content = lines[i]
        rest = content[1:].strip()
        i += 1
        if not rest:
            value, i = _child(lines, i, indent)
            out.append(value)
            continue
        if _is_item(rest) or _key_split(rest) is not None:
            raise YAMLSubsetError(f"line {no}: a collection inside a block sequence item")
        out.append(_Flow(rest).whole())
        if i < len(lines) and lines[i][1] > indent:
            raise YAMLSubsetError(f"line {lines[i][0]}: multi-line values are outside the "
                                  "subset")
    if i < len(lines) and lines[i][1] > indent:
        raise YAMLSubsetError(f"line {lines[i][0]}: unexpected indentation")
    return out, i


def loads(text: str) -> Any:
    """The value of one YAML document in the subset (None when it is empty),
    as ``yaml.safe_load`` gives it."""
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][1])
    if i != len(lines):
        raise YAMLSubsetError(f"line {lines[i][0]}: unexpected text")
    return value


def _deep_update(base: Dict, update: Dict) -> Dict:
    for k, v in update.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_update(base[k], v)
        else:
            base[k] = v
    return base


def load_config(path: str) -> Dict[str, Any]:
    """The file's mapping over its ``includes`` (relative to the file), each
    merged in order before it."""
    path = os.path.abspath(path)
    with open(path) as f:
        cfg = loads(f.read()) or {}
    includes = cfg.pop("includes", [])
    merged: Dict[str, Any] = {}
    for inc in includes:
        inc_path = inc if os.path.isabs(inc) else os.path.join(os.path.dirname(path), inc)
        _deep_update(merged, load_config(inc_path))
    _deep_update(merged, cfg)
    return merged


def apply_overrides(cfg: Dict[str, Any], overrides: Sequence[str]) -> Dict[str, Any]:
    """Apply 'a.b=value' overrides in place, each value read as a YAML
    document (``YAMLSubsetError`` where it is outside the subset)."""
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, val = ov.split("=", 1)
        val = loads(val)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return cfg


def build_config(path: str, overrides: Sequence[str] = ()) -> Dict[str, Any]:
    return apply_overrides(load_config(path), overrides)


def create_grid(base_cfg: Dict[str, Any], sweep_yml: str) -> List[Dict[str, Any]]:
    """The cartesian grid of ``base_cfg`` over a sweep file of dotted keys,
    each mapped to a list of values (``optim.lr_initial: [5.0e-4,
    2.0e-4]``); each config carries its ``sweep_point``."""
    with open(sweep_yml) as f:
        sweep = loads(f.read()) or {}
    keys = list(sweep)
    for k, v in sweep.items():
        if not isinstance(v, list):
            raise ValueError(f"sweep key {k!r} must map to a list, got {type(v)}")
    grid = []
    for vals in itertools.product(*(sweep[k] for k in keys)):
        cfg = copy.deepcopy(base_cfg)
        apply_overrides(cfg, [f"{k}={v}" for k, v in zip(keys, vals)])
        cfg["sweep_point"] = {k: v for k, v in zip(keys, vals)}
        grid.append(cfg)
    return grid
