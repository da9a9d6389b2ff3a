"""Structured per-run metric logging (the port's copy of ``dlq_tpu.runlog``,
the same file formats, so either package reads what the other wrote).

``RunLogger.log(metrics, params, extra)`` appends a row carrying timestamp,
script, run-id, tag, host environment info, params/extra JSON and one
``m_<metric>`` column per metric to ``<root>/<sheet>.jsonl``, one sheet per
script; ``export_xlsx`` regenerates an ``.xlsx`` workbook from the JSONL
with a stdlib-only writer (``write_xlsx``), and ``read_xlsx_rows`` reads one
back. Metric values may be tensors on any device (``_jsonable``).
"""

from __future__ import annotations

import datetime
import functools
import getpass
import hashlib
import json
import os
import platform
import socket
import sys
import time
import zipfile
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np


def _env_info() -> Dict[str, Any]:
    try:
        user = getpass.getuser()
    except Exception:
        user = "?"
    return {
        "host": socket.gethostname(),
        "user": user,
        "os": f"{platform.system()} {platform.release()}",
        "python": platform.python_version(),
        "cpu": platform.machine(),
    }


def _run_id() -> str:
    # sha1(time+pid)[:8]
    return hashlib.sha1(f"{time.time()}-{os.getpid()}".encode()).hexdigest()[:8]


class RunLogger:
    """Append experiment rows to ``<root>/<sheet>.jsonl``; export to xlsx."""

    def __init__(self, root: str = "runlogs", script: Optional[str] = None, tag: str = ""):
        self.root = root
        self.script = script or os.path.basename(getattr(sys.modules.get("__main__"), "__file__", "interactive") or "interactive")
        self.sheet = os.path.splitext(self.script)[0] or "interactive"
        self.tag = tag
        self.run_id = _run_id()
        self.env = _env_info()
        os.makedirs(root, exist_ok=True)

    @property
    def path(self) -> str:
        return os.path.join(self.root, f"{self.sheet}.jsonl")

    def log(
        self,
        metrics: Dict[str, Any],
        params: Optional[Dict[str, Any]] = None,
        extra: Optional[Dict[str, Any]] = None,
        tag: Optional[str] = None,
    ) -> Dict[str, Any]:
        row: Dict[str, Any] = {
            "timestamp": datetime.datetime.now().isoformat(timespec="seconds"),
            "script": self.script,
            "run_id": self.run_id,
            "tag": tag if tag is not None else self.tag,
            **self.env,
            "params": params or {},
            "extra": extra or {},
        }
        for k, v in (metrics or {}).items():
            row[f"m_{k}"] = _jsonable(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")
        return row

    def rows(self) -> List[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]

    def export_xlsx(self, path: Optional[str] = None) -> str:
        """Regenerate the whole workbook (one sheet per jsonl file in root)."""
        path = path or os.path.join(self.root, "results.xlsx")
        sheets: Dict[str, List[Dict[str, Any]]] = {}
        for fn in sorted(os.listdir(self.root)):
            if fn.endswith(".jsonl"):
                with open(os.path.join(self.root, fn)) as f:
                    sheets[os.path.splitext(fn)[0]] = [json.loads(l) for l in f if l.strip()]
        write_xlsx(path, sheets)
        return path

    def log_returned_metrics(self, params: Optional[Dict[str, Any]] = None) -> Callable:
        """Decorator: log the dict a function returns."""

        def deco(fn: Callable) -> Callable:
            @functools.wraps(fn)
            def wrapper(*a, **kw):
                out = fn(*a, **kw)
                if isinstance(out, dict):
                    self.log(out, params=params, extra={"fn": fn.__name__})
                return out

            return wrapper

        return deco


def _jsonable(v: Any) -> Any:
    """A JSON value for ``v``: as is when JSON takes it; a tensor (any
    device) or numpy value as its Python number or nested list; else
    ``float(v)``, else ``str(v)``."""
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        v = v.tolist() if v.ndim else v.item()
    elif isinstance(v, np.generic):
        v = v.item()
    try:
        json.dumps(v)
        return v
    except TypeError:
        try:
            return float(v)
        except (TypeError, ValueError):
            return str(v)


# ---------------------------------------------------------------------------
# Minimal xlsx writer (stdlib only). xlsx = zip of OOXML parts; we emit inline
# strings so no shared-string table is needed.
# ---------------------------------------------------------------------------

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
{overrides}
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""


def _esc(s: str) -> str:
    return (
        str(s)
        .replace("&", "&amp;")
        .replace("<", "&lt;")
        .replace(">", "&gt;")
        .replace('"', "&quot;")
    )


def _col_name(i: int) -> str:
    name = ""
    i += 1
    while i:
        i, r = divmod(i - 1, 26)
        name = chr(65 + r) + name
    return name


def _sheet_xml(rows: List[List[Any]]) -> str:
    out = [
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>',
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"><sheetData>',
    ]
    for r, row in enumerate(rows, start=1):
        cells = []
        for c, v in enumerate(row):
            ref = f"{_col_name(c)}{r}"
            if isinstance(v, bool):
                cells.append(f'<c r="{ref}" t="b"><v>{int(v)}</v></c>')
            elif isinstance(v, (int, float)) and v == v and v not in (float("inf"), float("-inf")):
                cells.append(f'<c r="{ref}"><v>{v}</v></c>')
            elif v is None:
                continue
            else:
                cells.append(f'<c r="{ref}" t="inlineStr"><is><t xml:space="preserve">{_esc(v)}</t></is></c>')
        out.append(f'<row r="{r}">' + "".join(cells) + "</row>")
    out.append("</sheetData></worksheet>")
    return "".join(out)


def write_xlsx(path: str, sheets: Dict[str, Iterable[Dict[str, Any]]]) -> None:
    """Write a workbook from {sheet_name: [row_dict, ...]} with auto-expanding
    columns (union of keys, first-seen order)."""
    sheet_parts: Dict[str, str] = {}
    for name, rows in sheets.items():
        rows = list(rows)
        cols: List[str] = []
        for row in rows:
            for k in row:
                if k not in cols:
                    cols.append(k)
        table = [cols] + [
            [_cell(row.get(c)) for c in cols] for row in rows
        ]
        sheet_parts[name[:31] or "Sheet1"] = _sheet_xml(table)

    if not sheet_parts:
        sheet_parts["Sheet1"] = _sheet_xml([[]])

    names = list(sheet_parts)
    wb_sheets = "".join(
        f'<sheet name="{_esc(n)}" sheetId="{i+1}" r:id="rId{i+1}"/>' for i, n in enumerate(names)
    )
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
        'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
        f"<sheets>{wb_sheets}</sheets></workbook>"
    )
    wb_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        + "".join(
            f'<Relationship Id="rId{i+1}" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet{i+1}.xml"/>'
            for i in range(len(names))
        )
        + "</Relationships>"
    )
    overrides = "".join(
        f'<Override PartName="/xl/worksheets/sheet{i+1}.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
        for i in range(len(names))
    )
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES.format(overrides=overrides))
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", workbook)
        z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        for i, n in enumerate(names):
            z.writestr(f"xl/worksheets/sheet{i+1}.xml", sheet_parts[n])


def _cell(v: Any) -> Any:
    if isinstance(v, (dict, list)):
        return json.dumps(v)
    return v


def read_xlsx_rows(path: str, sheet_index: int = 0) -> List[List[str]]:
    """Tiny reader for round-trip tests (inline-string cells only)."""
    import re

    with zipfile.ZipFile(path) as z:
        xml = z.read(f"xl/worksheets/sheet{sheet_index+1}.xml").decode()
    rows = []
    for rm in re.finditer(r"<row [^>]*>(.*?)</row>", xml, re.S):
        cells = []
        for cm in re.finditer(r"<c [^>]*?>(?:<is><t[^>]*>(.*?)</t></is>|<v>(.*?)</v>)</c>", rm.group(1), re.S):
            cells.append(cm.group(1) if cm.group(1) is not None else cm.group(2))
        rows.append(cells)
    return rows
