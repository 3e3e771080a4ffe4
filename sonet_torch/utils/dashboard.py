"""Live training dashboard, the reference's visdom role, on the standard
library only (port of the JAX package's ``utils/dashboard.py``).

The ``Trainer`` writes one JSON record a line to
``<run>/<name>_metrics.jsonl`` (``utils/logging.py``).  This module serves
those files as live SVG charts from an HTTP daemon:

    sonet-torch monitor --root checkpoints/ --port 8322

- it follows the files while a run trains, through a byte cursor
  (``since``), so a poll reads only what was appended;
- one chart a metric, ``train_*`` / ``test_*`` / ``eval_*`` of one name
  drawn together;
- it reads files only, so it can start and stop at any time, on any
  machine that sees the run directories, with or without torch.
"""

from __future__ import annotations

import html
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple
from urllib.parse import parse_qs, quote, urlparse

__all__ = ["read_metrics", "list_runs", "make_dashboard_server"]


def read_metrics(run_dir: str, since: int = 0,
                 name: str = "train") -> Tuple[List[dict], int]:
    """Parse ``<run_dir>/<name>_metrics.jsonl`` starting at byte ``since``.

    Returns (rows, next_cursor).  ``next_cursor`` is a byte offset that
    only advances past complete lines, so a partially-written trailing
    line (the trainer appends with line buffering) is re-read next poll
    instead of being lost or mis-parsed.
    """
    path = os.path.join(run_dir, f"{name}_metrics.jsonl")
    rows: List[dict] = []
    if not os.path.exists(path):
        return rows, 0
    with open(path, "rb") as f:
        f.seek(since)
        chunk = f.read()
    end = chunk.rfind(b"\n")
    if end == -1:  # nothing complete yet
        return rows, since
    for line in chunk[:end].split(b"\n"):
        if not line.strip():
            continue
        try:
            rows.append(json.loads(line))
        except ValueError:
            pass  # malformed-but-complete line: skip, don't wedge the cursor
    return rows, since + end + 1


def list_runs(root: str) -> List[dict]:
    """Run dirs under ``root`` (or ``root`` itself) that have metrics.

    A missing or unreadable root gives [] instead of raising, so a
    long-lived dashboard does not answer 500 to every request."""
    try:
        entries = sorted(os.listdir(root))
    except OSError:
        return []
    candidates = [root] + [os.path.join(root, d)
                           for d in entries
                           if os.path.isdir(os.path.join(root, d))]
    runs = []
    for d in candidates:
        jl = os.path.join(d, "train_metrics.jsonl")
        if os.path.exists(jl):
            runs.append({
                "name": os.path.relpath(d, root) if d != root else ".",
                "mtime": os.path.getmtime(jl),
                "size": os.path.getsize(jl),
                "has_config": os.path.exists(os.path.join(d, "config.json")),
            })
    return runs


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>sonet-torch monitor</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 1.2em; color: #222; }}
 h1 {{ font-size: 1.2em; }}  h2 {{ font-size: 1em; margin: 0.2em 0; }}
 .charts {{ display: flex; flex-wrap: wrap; gap: 1em; }}
 .card {{ border: 1px solid #ddd; border-radius: 6px; padding: 0.6em; }}
 svg {{ background: #fafafa; }}
 .legend span {{ margin-right: 1em; font-size: 0.85em; }}
 a {{ color: #0366d6; text-decoration: none; }}
 table {{ border-collapse: collapse; }} td, th {{ padding: 2px 10px; }}
</style></head><body>
<h1>sonet-torch monitor — <code id="run">{run}</code>
 <small id="status"></small></h1>
<div class="charts" id="charts"></div>
<script>
const RUN = {run_json}, REFRESH_MS = {refresh_ms};
let cursor = 0, rows = [];
const COLORS = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#ff7f0e"];

function familyOf(key) {{
  for (const p of ["train_", "test_", "eval_"])
    if (key.startsWith(p)) return [key.slice(p.length), p.slice(0, -1)];
  return [key, ""];
}}

function draw() {{
  const fams = new Map();   // base metric -> Map(series -> [[step, v]...])
  for (const r of rows) {{
    for (const [k, v] of Object.entries(r)) {{
      if (["step", "wall_s", "epoch"].includes(k)) continue;
      if (typeof v !== "number") continue;
      const [base, series] = familyOf(k);
      if (!fams.has(base)) fams.set(base, new Map());
      const m = fams.get(base);
      if (!m.has(series)) m.set(series, []);
      m.get(series).push([r.step, v]);
    }}
  }}
  const div = document.getElementById("charts");
  div.innerHTML = "";
  const W = 420, H = 180, PAD = 38;
  for (const [base, seriesMap] of [...fams].sort()) {{
    let lo = Infinity, hi = -Infinity, xlo = Infinity, xhi = -Infinity;
    for (const pts of seriesMap.values())
      for (const [x, y] of pts) {{
        if (isFinite(y)) {{ lo = Math.min(lo, y); hi = Math.max(hi, y); }}
        xlo = Math.min(xlo, x); xhi = Math.max(xhi, x);
      }}
    if (!isFinite(lo)) continue;
    if (hi === lo) {{ hi += 1; lo -= 1; }}
    if (xhi === xlo) xhi += 1;
    const sx = x => PAD + (x - xlo) / (xhi - xlo) * (W - PAD - 8);
    const sy = y => H - 22 - (y - lo) / (hi - lo) * (H - 34);
    let svg = `<svg width="${{W}}" height="${{H}}">`;
    svg += `<text x="4" y="12" font-size="10">${{hi.toPrecision(4)}}</text>`;
    svg += `<text x="4" y="${{H - 24}}" font-size="10">${{lo.toPrecision(4)}}</text>`;
    svg += `<text x="${{PAD}}" y="${{H - 6}}" font-size="10">step ${{xlo}}</text>`;
    svg += `<text x="${{W - 70}}" y="${{H - 6}}" font-size="10">${{xhi}}</text>`;
    let legend = "", ci = 0;
    for (const [series, pts] of [...seriesMap].sort()) {{
      const c = COLORS[ci++ % COLORS.length];
      const path = pts.filter(p => isFinite(p[1]))
        .map(p => `${{sx(p[0]).toFixed(1)}},${{sy(p[1]).toFixed(1)}}`).join(" ");
      svg += `<polyline fill="none" stroke="${{c}}" stroke-width="1.4" points="${{path}}"/>`;
      const last = pts[pts.length - 1];
      legend += `<span style="color:${{c}}">${{series || "value"}} = ${{last[1].toPrecision(5)}}</span>`;
    }}
    svg += `</svg>`;
    div.insertAdjacentHTML("beforeend",
      `<div class="card"><h2>${{base}}</h2>${{svg}}<div class="legend">${{legend}}</div></div>`);
  }}
}}

async function poll() {{
  try {{
    const r = await fetch(`api/metrics?run=${{encodeURIComponent(RUN)}}&since=${{cursor}}`);
    const j = await r.json();
    if (j.rows.length || cursor === 0) {{
      rows.push(...j.rows); draw();
    }}
    cursor = j.next;
    document.getElementById("status").textContent =
      `(${{rows.length}} rows, live)`;
  }} catch (e) {{
    document.getElementById("status").textContent = "(poll failed)";
  }}
  setTimeout(poll, REFRESH_MS);
}}
poll();
</script></body></html>
"""


def make_dashboard_server(root: str, port: int = 8322,
                          refresh_ms: int = 3000,
                          host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """HTTP daemon over the run dirs under ``root``.

    GET /                      run index (or straight to the only run)
    GET /run?name=<run>        live charts page
    GET /api/runs              run listing JSON
    GET /api/metrics?run=&since=   incremental JSONL rows
    """
    root = os.path.abspath(root)

    def resolve_run(name: str) -> Optional[str]:
        d = os.path.abspath(os.path.join(root, name))
        if d != root and not d.startswith(root + os.sep):
            return None  # path escape
        return d if os.path.isdir(d) else None

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code: int = 200) -> None:
            self._send(code, json.dumps(obj).encode())

        def do_GET(self):
            url = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(url.query).items()}
            if url.path == "/api/runs":
                return self._json({"root": root, "runs": list_runs(root)})
            if url.path == "/api/metrics":
                run = resolve_run(q.get("run", "."))
                if run is None:
                    return self._json({"error": "unknown run"}, 404)
                try:
                    since = int(q.get("since", "0"))
                except ValueError:
                    since = 0
                rows, nxt = read_metrics(run, since=max(0, since))
                return self._json({"rows": rows, "next": nxt})
            if url.path == "/run":
                run = q.get("name", ".")
                if resolve_run(run) is None:
                    return self._send(404, b"unknown run", "text/plain")
                # escape for <script> context: a run dir named with
                # markup (valid on Linux) must not break out of the
                # script block (stored XSS when exposed via --host)
                run_json = (json.dumps(run).replace("<", "\\u003c")
                            .replace(">", "\\u003e"))
                page = _PAGE.format(run=html.escape(run),
                                    run_json=run_json,
                                    refresh_ms=int(refresh_ms))
                return self._send(200, page.encode(), "text/html")
            if url.path == "/":
                runs = list_runs(root)
                if len(runs) == 1:
                    self.send_response(302)
                    # percent-encode: html.escape does not cover URL
                    # metacharacters (space/&/#/%) in run-dir names
                    self.send_header(
                        "Location",
                        f"/run?name={quote(runs[0]['name'], safe='')}")
                    self.end_headers()
                    return
                items = "".join(
                    f'<tr><td><a href="/run?name='
                    f'{quote(r["name"], safe="")}">'
                    f'{html.escape(r["name"])}</a></td>'
                    f'<td>{r["size"]}B</td></tr>' for r in runs)
                body = (f"<html><body><h1>runs under {html.escape(root)}"
                        f"</h1><table><tr><th>run</th><th>metrics</th></tr>"
                        f"{items}</table></body></html>")
                return self._send(200, body.encode(), "text/html")
            return self._send(404, b"not found", "text/plain")

    srv = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    srv._thread = thread  # keeps a handle for callers that join on close
    thread.start()
    return srv
