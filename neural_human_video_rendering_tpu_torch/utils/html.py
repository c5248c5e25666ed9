"""Static HTML gallery writer (dominate-free util/html.py equivalent).

Reproduces the reference's artifact contract: a browsable
``{checkpoints_dir}/{name}/web/index.html`` image gallery of training
intermediates (reference: README.md:82). `dominate` is not available in this
environment, so the page is emitted directly — same output, no dependency.
"""

from __future__ import annotations

import html
import os
from typing import List, Sequence, Tuple


class HTMLGallery:
    def __init__(self, web_dir: str, title: str, refresh: int = 0):
        self.web_dir = web_dir
        self.img_dir = os.path.join(web_dir, "images")
        self.title = title
        self.refresh = refresh
        self.rows: List[Tuple[str, List[Tuple[str, str]]]] = []
        os.makedirs(self.img_dir, exist_ok=True)

    def add_images(self, header: str, named_files: Sequence[Tuple[str, str]]):
        """Row of (label, filename-inside-images/) pairs under a header."""
        self.rows.append((header, list(named_files)))

    def save(self) -> str:
        parts = ["<!DOCTYPE html><html><head><meta charset='utf-8'>"]
        if self.refresh:
            parts.append(f"<meta http-equiv='refresh' content='{self.refresh}'>")
        parts.append(f"<title>{html.escape(self.title)}</title>")
        parts.append(
            "<style>body{font-family:sans-serif;background:#111;color:#eee}"
            "table{border-spacing:8px}td{text-align:center;vertical-align:top}"
            "img{max-width:256px;border:1px solid #444}</style></head><body>")
        parts.append(f"<h1>{html.escape(self.title)}</h1>")
        for header, files in reversed(self.rows):
            parts.append(f"<h3>{html.escape(header)}</h3><table><tr>")
            for label, fname in files:
                parts.append(
                    f"<td><a href='images/{fname}'><img src='images/{fname}'>"
                    f"</a><br>{html.escape(label)}</td>")
            parts.append("</tr></table>")
        parts.append("</body></html>")
        path = os.path.join(self.web_dir, "index.html")
        with open(path, "w") as f:
            f.write("".join(parts))
        return path
