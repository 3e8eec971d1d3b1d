"""One config system, YAML -> dict with dotted overrides (counterpart of
``tss_dprnn_tpu/utils/config.py``).

The card's machine has no yaml package, so the files and the ``--set``
values are read by :func:`parse_yaml`, a reader of the YAML subset that
``configs/*.yaml`` use:

- block mappings nested by indentation (spaces), with plain keys;
- flow lists (``[a, 1, [2, 3]]``) on one line;
- comments, on a line of their own or after a value;
- scalars resolved as PyYAML's ``safe_load`` resolves them (YAML 1.1): an
  empty value, ``~`` and ``null`` -> None; ``true`` / ``false`` -> bool;
  ints (decimal, octal ``0...``, ``0x``, ``0b``, with ``_``); floats (with a
  dot: ``1.0e-5`` is a float, ``5e-4`` stays a string, as in YAML 1.1;
  ``.inf``, ``.nan``); everything else, and quoted scalars, -> str.

For everything it accepts it returns what ``yaml.safe_load`` returns. It
raises :class:`YamlSubsetError` on everything else, rather than misread it:
anchors and aliases, tags, block scalars (``|``, ``>``), block sequences,
flow mappings, documents markers and multiple documents, directives,
multi-line plain or flow scalars, tabs in indentation, and the scalars YAML
1.1 would turn into something the subset has no type for: the ``yes`` /
``no`` / ``on`` / ``off`` booleans, sexagesimal numbers and timestamps.
"""

from __future__ import annotations

import copy
import logging
import re
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


class YamlSubsetError(ValueError):
    """The text uses YAML outside the subset this reader takes."""


# PyYAML's implicit resolvers for YAML 1.1 (yaml/resolver.py)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:true|True|TRUE|false|False|FALSE)$")
_BOOL_11 = re.compile(r"^(?:yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# a plain scalar may not start with these (YAML's indicators)
_INDICATORS = set("-?:,[]{}#&*!|>'\"%@`")
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "r": "\r", "0": "\0"}


def _resolve_plain(text: str) -> Any:
    """A plain scalar -> its value, as PyYAML's SafeLoader resolves it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() == "true"
    if _BOOL_11.match(text) or _SEXAGESIMAL.match(text) or _TIMESTAMP.match(text) \
            or text in ("=", "<<"):
        raise YamlSubsetError(f"{text!r}: YAML 1.1 gives this plain scalar a type outside the "
                              "subset (yes/no/on/off, sexagesimal, timestamp); quote it")
    if _INT.match(text):
        digits = text.replace("_", "")
        sign = -1 if digits[0] == "-" else 1
        digits = digits.lstrip("+-")
        if digits == "0":
            return 0
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if digits.startswith("0"):
            return sign * int(digits, 8)
        return sign * int(digits)
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        value = value.lstrip("+-")
        if value == ".inf":
            return sign * float("inf")
        if value == ".nan":
            return float("nan")
        return sign * float(value)
    return text


class _Line:
    """Scans one value: a scalar or a flow list, then an optional comment."""

    def __init__(self, text: str, where: str):
        self.text, self.pos, self.where = text, 0, where

    def fail(self, what: str) -> YamlSubsetError:
        return YamlSubsetError(f"{self.where}: {what}")

    def skip_spaces(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] == " ":
            self.pos += 1

    def at_end(self) -> bool:
        """Only spaces and a comment are left."""
        self.skip_spaces()
        return self.pos >= len(self.text) or self.text[self.pos] == "#"

    def value(self, flow: bool = False) -> Any:
        self.skip_spaces()
        if self.pos >= len(self.text):
            return None
        c = self.text[self.pos]
        if c == "[":
            return self.flow_list()
        if c in "'\"":
            return self.quoted(c)
        if c in "&*!":
            raise self.fail("anchors, aliases and tags are outside the subset")
        if c in "|>":
            raise self.fail("block scalars are outside the subset")
        if c == "{":
            raise self.fail("flow mappings are outside the subset")
        if c in _INDICATORS and not (c in "-?:" and self.pos + 1 < len(self.text)
                                     and self.text[self.pos + 1] not in " ,[]{}"):
            raise self.fail(f"a plain scalar cannot start with {c!r}")
        return _resolve_plain(self.plain(flow))

    def plain(self, flow: bool) -> str:
        start = self.pos
        stops = ",[]{}" if flow else ""
        while self.pos < len(self.text):
            c = self.text[self.pos]
            if c == "#" and self.text[self.pos - 1] == " ":
                break
            if c == ":" and (self.pos + 1 == len(self.text) or self.text[self.pos + 1] == " "
                             or (flow and self.text[self.pos + 1] in stops)):
                raise self.fail("a ': ' inside a value (a mapping) is outside the subset")
            if c in stops:
                break
            self.pos += 1
        return self.text[start:self.pos].rstrip(" ")

    def quoted(self, q: str) -> str:
        out: List[str] = []
        self.pos += 1
        while True:
            if self.pos >= len(self.text):
                raise self.fail("an unclosed quoted scalar (multi-line scalars are outside "
                                "the subset)")
            c = self.text[self.pos]
            if c == q:
                if q == "'" and self.text[self.pos + 1:self.pos + 2] == "'":
                    out.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(out)
            if q == '"' and c == "\\":
                esc = self.text[self.pos + 1:self.pos + 2]
                if esc not in _ESCAPES:
                    raise self.fail(f"the escape \\{esc} is outside the subset")
                out.append(_ESCAPES[esc])
                self.pos += 2
                continue
            out.append(c)
            self.pos += 1

    def flow_list(self) -> list:
        self.pos += 1
        items: list = []
        while True:
            self.skip_spaces()
            if self.pos >= len(self.text):
                raise self.fail("an unclosed flow list (multi-line flow lists are outside "
                                "the subset)")
            if self.text[self.pos] == "]":
                self.pos += 1
                return items
            if self.text[self.pos] == ",":
                raise self.fail("an empty flow list item")
            items.append(self.value(flow=True))
            self.skip_spaces()
            if self.pos < len(self.text) and self.text[self.pos] == ",":
                self.pos += 1
            elif self.pos >= len(self.text) or self.text[self.pos] != "]":
                raise self.fail("expected ',' or ']' in a flow list")


def _split_key(body: str, where: str) -> Tuple[Any, str]:
    """``key: rest`` -> (resolved key, rest)."""
    if body[0] in _INDICATORS:
        what = ("block sequences are" if body[:2] in ("- ", "-") else
                "quoted keys and keys starting with an indicator are")
        raise YamlSubsetError(f"{where}: {what} outside the subset")
    i = 0
    while True:
        i = body.find(":", i)
        if i < 0:
            raise YamlSubsetError(f"{where}: expected 'key: value' (multi-line plain scalars "
                                  "are outside the subset)")
        if i + 1 == len(body) or body[i + 1] == " ":
            break
        i += 1
    key = body[:i].rstrip(" ")
    if " #" in key:
        raise YamlSubsetError(f"{where}: expected 'key: value'")
    return _resolve_plain(key), body[i + 1:]


def parse_yaml(text: str, name: str = "<yaml>") -> Any:
    """YAML text in the subset above -> what ``yaml.safe_load`` returns: a
    dict for a mapping, the value for a lone value, None for no content."""
    lines: List[Tuple[int, str, str]] = []  # (indent, body, where)
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        stripped = raw.lstrip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if stripped[0] == "\t" or "\t" in raw[:len(raw) - len(stripped)]:
            raise YamlSubsetError(f"{where}: tabs in indentation are outside the subset")
        if raw.startswith(("---", "...")) or raw.startswith("%"):
            raise YamlSubsetError(f"{where}: document markers and directives are outside "
                                  "the subset")
        lines.append((len(raw) - len(stripped), stripped.rstrip(), where))
    if not lines:
        return None
    first_indent, first, where = lines[0]
    try:
        _split_key(first, where)
    except YamlSubsetError:
        # not a mapping: one value, alone
        if len(lines) > 1:
            raise YamlSubsetError(f"{lines[1][2]}: more than one top-level value is outside "
                                  "the subset")
        line = _Line(first, where)
        value = line.value()
        if not line.at_end():
            raise line.fail("trailing text after the value")
        return value
    mapping, i = _block_mapping(lines, 0, first_indent)
    if i != len(lines):
        raise YamlSubsetError(f"{lines[i][2]}: bad indentation")
    return mapping


def _block_mapping(lines, i: int, indent: int) -> Tuple[dict, int]:
    out: dict = {}
    while i < len(lines) and lines[i][0] == indent:
        _, body, where = lines[i]
        key, rest = _split_key(body, where)
        line = _Line(rest, where)
        i += 1
        if line.at_end():
            if i < len(lines) and lines[i][0] > indent:
                out[key], i = _block_mapping(lines, i, lines[i][0])
            else:
                out[key] = None
            continue
        out[key] = line.value()
        if not line.at_end():
            raise line.fail("trailing text after the value")
        if i < len(lines) and lines[i][0] > indent:
            raise YamlSubsetError(f"{lines[i][2]}: multi-line plain scalars are outside the "
                                  "subset")
    if i < len(lines) and lines[i][0] > indent:
        raise YamlSubsetError(f"{lines[i][2]}: bad indentation")
    return out, i


def load_config(path: str, overrides: Optional[List[str]] = None) -> Dict[str, Any]:
    """A config file plus ``key.path=value`` overrides. Of the JAX package's
    ``jax:`` section only the multi-host keys have a counterpart
    (:func:`distributed_args`); the rest (compilation cache, platforms) is
    logged and ignored."""
    with open(path) as f:
        config = parse_yaml(f.read(), path) or {}
    for item in overrides or []:
        key, _, raw = item.partition("=")
        set_by_path(config, key.strip(), _parse_override(raw))
    if config.get("jax") is not None:
        logger.info("config section 'jax' %s: its distributed keys start the process group, "
                    "the rest is for the JAX package and ignored", config["jax"])
    return config


def distributed_args(config: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """The arguments of ``parallel.initialize_distributed`` that the config's
    ``jax:`` section asks for (JAX ``utils/config.py:79-95``), or None
    without ``distributed: true``::

        jax:
          distributed: true               # alone: torchrun's environment
          coordinator_address: host:port  # explicit, with the next two
          num_processes: 4
          process_id: 0
    """
    section = config.get("jax") or {}
    if not section.get("distributed"):
        return None
    return {"coordinator_address": section.get("coordinator_address"),
            "num_processes": section.get("num_processes"),
            "process_id": section.get("process_id")}


_SCI_FLOAT = re.compile(r"^[+-]?(\d+(\.\d*)?|\.\d+)[eE][+-]?\d+$")


def _parse_override(raw: str) -> Any:
    """Parse an override value as YAML, patching YAML 1.1's one numeric gap:
    bare scientific notation (``--set lr=5e-4``) parses as a string because
    YAML 1.1 floats require a dot. Only that exact shape is coerced, and
    only here (a file's ``5e-4`` stays a string, as with the JAX package)."""
    value = parse_yaml(raw, "override")
    if isinstance(value, str) and _SCI_FLOAT.match(value):
        return float(value)
    return value


def set_by_path(config: Dict[str, Any], dotted: str, value: Any) -> None:
    node = config
    parts = dotted.split(".")
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def merged(base: Dict[str, Any], extra: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)

    def rec(dst, src):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                rec(dst[k], v)
            else:
                dst[k] = v

    rec(out, extra)
    return out


def model_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """The model section, normalized for models.registry.build_model."""
    mc = dict(config.get("model") or {})
    if "_target_" in mc and "target" not in mc:
        mc["target"] = mc.pop("_target_")
    return mc


def optimizer_config(config: Dict[str, Any]) -> Dict[str, Any]:
    oc = dict(config.get("optimizer") or {})
    oc.pop("_target_", None)  # torch class path in reference configs
    return oc
