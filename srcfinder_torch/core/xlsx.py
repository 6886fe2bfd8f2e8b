"""Minimal stdlib .xlsx writer and reader (zipfile + XML).

The reference's canonical trigger artifact for the whole msf_flow layer
is an Excel plume list (written at salience_predictions.py:187-192 via
openpyxl, read at srcfinder_util.py:2042-2081 via pandas.read_excel).
Neither openpyxl nor xlsxwriter ships in this environment, and an xlsx
file is just a zip of XML — so this module implements the minimum of
ECMA-376 SpreadsheetML needed for plume lists:

- writer: one sheet, inline strings, numbers, bools, blanks.
- reader: first (or named) sheet; shared strings, inline strings,
  formula-cached strings, booleans, numbers; sparse cells by A1 ref
  (msf-flow reads ``.xlsx`` plume lists with it).
"""

from __future__ import annotations

import zipfile
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

__all__ = ["write_xlsx", "read_xlsx_rows"]

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>
</Types>
"""

_ROOT_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>
"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>
</Relationships>
"""


def _col_letters(idx: int) -> str:
    """0-based column index -> A1 letters."""
    out = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        out = chr(ord("A") + rem) + out
    return out


def _letters_col(ref: str) -> int:
    """A1 cell ref -> 0-based column index."""
    out = 0
    for ch in ref:
        if ch.isdigit():
            break
        out = out * 26 + (ord(ch.upper()) - ord("A") + 1)
    return out - 1


def _cell_xml(ref: str, value) -> str:
    if value is None:
        return ""
    if isinstance(value, bool):
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    if isinstance(value, (int, float)):
        if value != value:  # NaN -> blank (Excel has no NaN literal)
            return ""
        return f'<c r="{ref}"><v>{value!r}</v></c>'
    text = escape(str(value))
    return f'<c r="{ref}" t="inlineStr"><is><t xml:space="preserve">{text}</t></is></c>'


def write_xlsx(path: str, rows, sheet_name: str = "Sheet1") -> str:
    """Write ``rows`` (iterable of iterables of str/number/bool/None)
    as a single-sheet xlsx. Returns ``path``."""
    body = []
    for r, row in enumerate(rows):
        cells = "".join(_cell_xml(f"{_col_letters(c)}{r + 1}", v)
                        for c, v in enumerate(row))
        body.append(f'<row r="{r + 1}">{cells}</row>')
    sheet = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main"><sheetData>'
        + "".join(body) + "</sheetData></worksheet>")
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/'
        'spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats'
        '.org/officeDocument/2006/relationships"><sheets>'
        f'<sheet name="{escape(sheet_name)}" sheetId="1" r:id="rId1"/>'
        '</sheets></workbook>')
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _ROOT_RELS)
        z.writestr("xl/workbook.xml", workbook)
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
    return path


def _shared_strings(z: zipfile.ZipFile):
    try:
        data = z.read("xl/sharedStrings.xml")
    except KeyError:
        return []
    root = ET.fromstring(data)
    out = []
    for si in root.findall(f"{_NS}si"):
        # plain <t> or rich runs <r><t>
        parts = [t.text or "" for t in si.iter(f"{_NS}t")]
        out.append("".join(parts))
    return out


def _sheet_path(z: zipfile.ZipFile, sheet_name):
    names = z.namelist()
    wb = ET.fromstring(z.read("xl/workbook.xml"))
    rid_ns = ("{http://schemas.openxmlformats.org/officeDocument/2006/"
              "relationships}id")
    sheets = [(s.get("name"), s.get(rid_ns))
              for s in wb.iter(f"{_NS}sheet")]
    rels = {}
    if "xl/_rels/workbook.xml.rels" in names:
        rroot = ET.fromstring(z.read("xl/_rels/workbook.xml.rels"))
        for rel in rroot:
            rels[rel.get("Id")] = rel.get("Target")
    target = None
    if sheet_name is None or isinstance(sheet_name, int):
        idx = 0 if sheet_name is None else sheet_name
        if idx < len(sheets):
            target = rels.get(sheets[idx][1])
    else:
        for name, rid in sheets:
            if name == sheet_name:
                target = rels.get(rid)
                break
        else:
            raise KeyError(f"sheet {sheet_name!r} not found "
                           f"(have {[s[0] for s in sheets]})")
    if target is None:
        # fall back to the conventional location
        return "xl/worksheets/sheet1.xml"
    target = target.lstrip("/")
    return target if target.startswith("xl/") else "xl/" + target


def _cell_value(c, strings):
    ctype = c.get("t", "n")
    if ctype == "inlineStr":
        return "".join(t.text or "" for t in c.iter(f"{_NS}t"))
    v = c.find(f"{_NS}v")
    if v is None or v.text is None:
        return None
    if ctype == "s":
        return strings[int(v.text)]
    if ctype == "str":
        return v.text
    if ctype == "b":
        return bool(int(v.text))
    text = v.text
    try:
        f = float(text)
    except ValueError:
        return text
    return int(f) if f.is_integer() and "." not in text \
        and "e" not in text.lower() else f


def read_xlsx_rows(path: str, sheet_name=None):
    """Read one sheet as a dense list of row lists (None for blanks)."""
    with zipfile.ZipFile(path) as z:
        strings = _shared_strings(z)
        root = ET.fromstring(z.read(_sheet_path(z, sheet_name)))
        rows = {}
        ncols = 0
        for row in root.iter(f"{_NS}row"):
            r = int(row.get("r", len(rows) + 1)) - 1
            vals = {}
            for c in row.findall(f"{_NS}c"):
                ref = c.get("r")
                col = _letters_col(ref) if ref else len(vals)
                vals[col] = _cell_value(c, strings)
                ncols = max(ncols, col + 1)
            rows[r] = vals
    nrows = max(rows) + 1 if rows else 0
    out = [[None] * ncols for _ in range(nrows)]
    for r, vals in rows.items():
        for col, v in vals.items():
            out[r][col] = v
    return out
