"""Per-agent YAML settings (reference ``src/Settings.cc`` / Settings.h).

Port of ``mam3slam_tpu.io.settings``: the same ``File.version`` gate,
camera sections (Pinhole / KannalaBrandt8 / Rectified), ORB parameters
and viewer / load-save keys.  The reference reads the file with
``yaml.safe_load``; the port reads the flat OpenCV-FileStorage dialect
itself (a leading ``%YAML:1.0`` directive, ``key: value`` lines with
dotted keys, ``#`` comments, quoted and plain scalars), with no YAML
package, and refuses other YAML (sub-mappings, sequences, tags).  Plain
scalars get the types ``safe_load`` gives them (its YAML 1.1 resolver),
since the gates depend on them: ``"1.0"`` is a string and passes the
version gate, an unquoted ``1.0`` is a float and fails it, ``1`` is an
int, and ``1e-5`` (no dot) is a string that ``load_settings`` then
converts with ``float``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

import torch

from mam3slam_tpu_torch.geometry import cameras


class SettingsError(ValueError):
    pass


@dataclass
class Settings:
    camera_type: str
    fx: float
    fy: float
    cx: float
    cy: float
    dist: tuple              # (k1, k2, p1, p2) or KB8 (k1..k4)
    width: int
    height: int
    fps: float
    rgb: bool
    n_features: int
    scale_factor: float
    n_levels: int
    ini_th_fast: int
    min_th_fast: int
    new_width: Optional[int] = None
    new_height: Optional[int] = None
    atlas_load_file: str = ""
    atlas_save_file: str = ""
    raw: dict = field(default_factory=dict)

    @property
    def eff_width(self) -> int:
        """Working image width after the optional Camera.newWidth resize."""
        return self.new_width or self.width

    @property
    def eff_height(self) -> int:
        return self.new_height or self.height

    def camera(self, device=torch.device("cuda")) -> cameras.Camera:
        """Camera at the WORKING resolution on ``device``: focal lengths
        and principal point scale with the resize; normalized distortion
        coefficients do not (reference Settings.cc resize handling)."""
        sx = self.eff_width / self.width
        sy = self.eff_height / self.height
        fx, fy = self.fx * sx, self.fy * sy
        cx, cy = self.cx * sx, self.cy * sy
        if self.camera_type == "KannalaBrandt8":
            return cameras.make_kb8(fx, fy, cx, cy, *self.dist[:4],
                                    device=device)
        return cameras.make_pinhole(fx, fy, cx, cy, tuple(self.dist[:4]),
                                    device=device)


# ---------------------------------------------------------------------------
# the flat OpenCV-FileStorage YAML dialect
# ---------------------------------------------------------------------------

# PyYAML's YAML 1.1 implicit resolvers (yaml/resolver.py)
_BOOL = {"yes": True, "Yes": True, "YES": True, "true": True, "True": True,
         "TRUE": True, "on": True, "On": True, "ON": True,
         "no": False, "No": False, "NO": False, "false": False,
         "False": False, "FALSE": False, "off": False, "Off": False,
         "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                      |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                      |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                      |[-+]?\.(?:inf|Inf|INF)
                      |\.(?:nan|NaN|NAN))$""", re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ",
            '"': '"', "/": "/", "\\": "\\"}


def _sexagesimal(text: str, conv) -> float:
    value = 0
    for part in text.split(":"):
        value = value * 60 + conv(part)
    return value


def _int(text: str) -> int:
    """PyYAML's construct_yaml_int."""
    v = text.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        return sign * _sexagesimal(v, int)
    return sign * int(v)


def _float(text: str) -> float:
    """PyYAML's construct_yaml_float."""
    v = text.replace("_", "").lower()
    sign = -1.0 if v[0] == "-" else 1.0
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        return sign * _sexagesimal(v, float)
    return sign * float(v)


def _plain(text: str):
    """A plain (unquoted) scalar, typed as ``yaml.safe_load`` types it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    return text


def _quoted(text: str, pos: int):
    """The quoted scalar starting at ``text[pos]``: (value, end index)."""
    q = text[pos]
    out, i = [], pos + 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":     # '' is a quote
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            nxt = text[i + 1:i + 2]
            if nxt not in _ESCAPES:
                raise SettingsError(f"unsupported escape \\{nxt} in {text!r}")
            out.append(_ESCAPES[nxt])
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), i + 1
        out.append(c)
        i += 1
    raise SettingsError(f"unterminated quoted scalar: {text!r}")


def _strip_comment(text: str) -> str:
    """A plain value up to a `` #`` comment."""
    m = re.search(r"(^|\s)#", text)
    return (text[:m.start()] if m else text).strip()


def _value(text: str):
    """The scalar after ``key:`` on one line."""
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, end = _quoted(text, 0)
        rest = text[end:].strip()
        if rest and not rest.startswith("#"):
            raise SettingsError(f"text after a quoted scalar: {text!r}")
        return value
    if text[:1] in ("!", "&", "*", "[", "{", "|", ">"):
        raise SettingsError(f"unsupported YAML construct: {text!r}")
    return _plain(_strip_comment(text))


_KEY = re.compile(r"^([^\s#'\"][^:#]*?)\s*:(?:\s+(.*))?$")


def parse_filestorage_yaml(text: str) -> dict:
    """The mapping that ``yaml.safe_load`` gives for the flat
    OpenCV-FileStorage dialect (the ``%YAML`` directive and a ``---``
    document marker skipped).  Raises SettingsError on any other YAML."""
    out: dict = {}
    for raw in text.splitlines():
        stripped = raw.strip()
        if (not stripped or stripped.startswith("#")
                or stripped.startswith("%YAML") or stripped == "---"):
            continue
        m = _KEY.match(raw)
        if not m:
            raise SettingsError(f"unsupported settings line: {raw!r}")
        key, rest = m.group(1), m.group(2)
        out[key] = (None if rest is None or _strip_comment(rest) == ""
                    else _value(rest))
    return out


def _req(d: dict, key: str):
    if key not in d:
        raise SettingsError(f"required parameter missing: {key}")
    return d[key]


def load_settings(path: str) -> Settings:
    with open(path) as f:
        d = parse_filestorage_yaml(f.read()) or {}

    version = d.get("File.version")
    if version != "1.0":
        # reference Agent ctor rejects settings without the version tag
        raise SettingsError(
            f"unsupported settings version {version!r} (need \"1.0\")")

    cam_type = _req(d, "Camera.type").strip('"')
    if cam_type in ("PinHole", "Pinhole"):
        dist = tuple(float(d.get(f"Camera1.{k}", 0.0))
                     for k in ("k1", "k2", "p1", "p2"))
    elif cam_type == "KannalaBrandt8":
        dist = tuple(float(_req(d, f"Camera1.{k}"))
                     for k in ("k1", "k2", "k3", "k4"))
    elif cam_type == "Rectified":
        dist = (0.0, 0.0, 0.0, 0.0)
    else:
        raise SettingsError(f"unknown Camera.type {cam_type!r}")

    return Settings(
        camera_type=cam_type,
        fx=float(_req(d, "Camera1.fx")),
        fy=float(_req(d, "Camera1.fy")),
        cx=float(_req(d, "Camera1.cx")),
        cy=float(_req(d, "Camera1.cy")),
        dist=dist,
        width=int(_req(d, "Camera.width")),
        height=int(_req(d, "Camera.height")),
        fps=float(d.get("Camera.fps", 30.0)),
        rgb=bool(d.get("Camera.RGB", 1)),
        n_features=int(d.get("ORBextractor.nFeatures", 1000)),
        scale_factor=float(d.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(d.get("ORBextractor.nLevels", 8)),
        ini_th_fast=int(d.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(d.get("ORBextractor.minThFAST", 7)),
        new_width=(int(d["Camera.newWidth"])
                   if d.get("Camera.newWidth") else None),
        new_height=(int(d["Camera.newHeight"])
                    if d.get("Camera.newHeight") else None),
        atlas_load_file=d.get("System.LoadAtlasFromFile", ""),
        atlas_save_file=d.get("System.SaveAtlasToFile", ""),
        raw=d,
    )
