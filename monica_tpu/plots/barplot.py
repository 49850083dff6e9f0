"""Stacked abundance barplot — self-contained HTML, no plotly dependency.

Re-designs `monica/plots/barplot.py` (reference):
* `_by_taxunit` row-sum by tax unit        (`barplot.py:19-27`)
* `filter_low_reads` threshold filter      (`barplot.py:30-40`; the
  reference never casts the CLI string threshold (`monica.py:87-90`),
  comparing str vs float — here it is a real number)
* stacked per-sample bars with host suffix (`barplot.py:56-118`)
* output file ``monica.barplot.html``      (`barplot.py:118`)

Design: categorical palette = the 8 validated slots (fixed order);
taxa beyond 8 fold into a gray "Other" so identity stays CVD-readable.
Full per-taxon data remains in the CSVs and the HTML's table view.

Tables are numpy (:class:`monica_tpu.stats.abundance.AbundanceTable`);
sums and the taxon ranking follow pandas' groupby/sort rules, so the
HTML is the one the former pandas implementation wrote.
"""

from __future__ import annotations

import html as _html
import json
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

BARPLOT_FILENAME = "monica.barplot.html"
READS_THRESHOLD = 15  # reference default (barplot.py:9)

# Validated categorical palette (8 slots, fixed order; light/dark steps).
_SERIES_LIGHT = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4", "#008300", "#4a3aa7", "#e34948"]
_SERIES_DARK = ["#3987e5", "#d95926", "#199e70", "#c98500", "#d55181", "#008300", "#9085e9", "#e66767"]
_OTHER_LIGHT, _OTHER_DARK = "#8a8984", "#706f6a"


def palette_colors(palette: str, n: int) -> tuple[list[str], list[str]] | None:
    """Resolve a matplotlib colormap name to (light, dark) hex series
    colors — the reference honors any cmap (`barplot.py:43-53`).  The
    validated default palette is used for ``default``/unknown names
    (it stays CVD-readable in both schemes, which arbitrary cmaps are
    not; the dark variant reuses the sampled colors)."""
    if not palette or palette == "default":
        return None
    try:
        import matplotlib

        cmap = matplotlib.colormaps[palette]
    except (ImportError, KeyError):
        print(f"barplot: unknown palette {palette!r}; using the validated default")
        return None
    pts = np.linspace(0.05, 0.95, max(n, 1))
    cols = [matplotlib.colors.to_hex(cmap(float(p))) for p in pts]
    return cols, cols


@dataclass
class TaxonTable:
    """Per-tax-unit rows x sample columns (NaN-free)."""

    taxa: list[str]
    samples: list[str]
    values: np.ndarray  # (taxa, samples) float64


def by_taxunit(table) -> TaxonTable:
    """Sum accession rows into tax-unit rows in first-appearance order,
    NaN as 0 (`barplot.py:19-27`).  Compensated (Kahan) summation in row
    order, as pandas' groupby sum does."""
    taxa: list[str] = []
    slot: dict[str, int] = {}
    for t in table.tax_units:
        if t not in slot:
            slot[t] = len(taxa)
            taxa.append(t)
    vals = np.nan_to_num(np.asarray(table.values, np.float64), nan=0.0)
    sums = np.zeros((len(taxa), len(table.samples)), np.float64)
    comp = np.zeros_like(sums)
    for t, row in zip(table.tax_units, vals):
        g = slot[t]
        y = row - comp[g]
        tot = sums[g] + y
        comp[g] = np.where(np.isnan(tot - sums[g] - y), 0.0, tot - sums[g] - y)
        sums[g] = tot
    return TaxonTable(taxa, list(table.samples), sums)


def filter_low_reads(norm: TaxonTable, raw: TaxonTable, threshold: float) -> TaxonTable:
    """Drop taxa whose *raw* counts are <= threshold in every sample
    (`barplot.py:30-40`)."""
    keep = (raw.values > float(threshold)).any(axis=1)
    where = {t: i for i, t in enumerate(norm.taxa)}
    rows = [where[t] for t, k in zip(raw.taxa, keep) if k and t in where]
    return TaxonTable([norm.taxa[i] for i in rows], norm.samples, norm.values[rows])


def _rank_descending(v: np.ndarray) -> np.ndarray:
    """Row order by descending value with pandas' ``sort_values``
    tie order (reversed quicksort argsort)."""
    idx = np.arange(len(v))[::-1]
    return idx[v[::-1].argsort(kind="quicksort")][::-1]


def plotter(
    norm_alignment_df,
    raw_alignment_df,
    output_folder: str | os.PathLike,
    palette: str = "default",  # matplotlib cmap name, or the validated default
    reads_threshold: float = READS_THRESHOLD,
    hosts: list[str] | None = None,
    guests: list[str] | None = None,
    mode: str | None = None,
    show_legend: bool = True,
    auto_open: bool = False,
) -> Path:
    """Render the stacked relative-abundance barplot to
    ``<output_folder>/monica.barplot.html``; returns the path."""
    norm_t = by_taxunit(norm_alignment_df)
    raw_t = by_taxunit(raw_alignment_df)
    norm_t = filter_low_reads(norm_t, raw_t, reads_threshold)

    samples = list(norm_t.samples)
    hosts = hosts or []
    guests = guests or []
    if hosts and guests:
        title = f"Guests: {', '.join(guests)}; host: {', '.join(hosts)}; analysis mode: {mode}"
    elif hosts:
        title = f"Host: {', '.join(hosts)}; analysis mode: {mode}"
    elif guests:
        title = f"Guests: {', '.join(guests)}; analysis mode: {mode}"
    else:
        title = f"Analysis mode: {mode}"

    # rank taxa by max abundance; first 8 get palette slots, rest fold
    ranked = _rank_descending(
        norm_t.values.max(axis=1) if len(samples) else np.zeros(len(norm_t.taxa))
    )
    order = [norm_t.taxa[i] for i in ranked]
    custom = palette_colors(palette, min(len(order), 8))
    light, dark = custom if custom else (_SERIES_LIGHT, _SERIES_DARK)
    series = []
    for i, r in enumerate(ranked[:8]):
        taxon = norm_t.taxa[r]
        name = f"{taxon}_(host)" if taxon in hosts else str(taxon)
        series.append(
            {
                "name": name,
                "taxon": str(taxon),
                "values": [float(v) for v in norm_t.values[r]],
                "cl": light[i],
                "cd": dark[i],
            }
        )
    rest = ranked[8:]
    if len(rest):
        other = norm_t.values[rest].T.sum(axis=1)
        series.append(
            {
                "name": f"Other ({len(rest)} taxa)",
                "taxon": "Other",
                "values": [float(v) for v in other],
                "cl": _OTHER_LIGHT,
                "cd": _OTHER_DARK,
            }
        )

    # full table rows (all taxa, unfolded) for the table view
    table_rows = [
        [str(norm_t.taxa[r])] + [float(v) for v in norm_t.values[r]] for r in ranked
    ]

    html_text = _render_html(title, samples, series, table_rows, show_legend)
    output_folder = Path(output_folder)
    output_folder.mkdir(parents=True, exist_ok=True)
    out = output_folder / BARPLOT_FILENAME
    out.write_text(html_text)
    if auto_open:
        # the reference opens the rendered plot in a browser
        # (plotly auto_open, reference barplot.py:118)
        import webbrowser

        webbrowser.open(out.resolve().as_uri())
    return out


def _render_html(title, samples, series, table_rows, show_legend) -> str:
    payload = json.dumps({"samples": samples, "series": series, "rows": table_rows})
    legend_css = "" if show_legend else "#legend{display:none}"
    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{_html.escape(title)}</title>
<style>
.viz-root {{
  color-scheme: light;
  --surface-1:#fcfcfb; --text-primary:#0b0b0b; --text-secondary:#52514e;
  --grid:#e8e7e3;
  font:14px/1.45 system-ui,-apple-system,sans-serif;
  background:var(--surface-1); color:var(--text-primary);
  max-width:960px; margin:2rem auto; padding:0 1rem;
}}
@media (prefers-color-scheme: dark) {{
  :root:where(:not([data-theme="light"])) .viz-root {{
    color-scheme:dark; --surface-1:#1a1a19; --text-primary:#ffffff;
    --text-secondary:#c3c2b7; --grid:#34332f;
  }}
}}
h1 {{ font-size:1.1rem; font-weight:600; }}
svg text {{ fill:var(--text-secondary); font-size:12px; }}
#legend {{ display:flex; flex-wrap:wrap; gap:.4rem 1rem; margin:.6rem 0; }}
#legend span {{ display:inline-flex; align-items:center; gap:.35rem;
  color:var(--text-secondary); font-size:12.5px; }}
#legend i {{ width:10px; height:10px; border-radius:3px; display:inline-block; }}
#tooltip {{ position:fixed; pointer-events:none; background:var(--surface-1);
  color:var(--text-primary); border:1px solid var(--grid); border-radius:6px;
  padding:.35rem .6rem; font-size:12.5px; opacity:0; transition:opacity .1s;
  box-shadow:0 2px 8px rgba(0,0,0,.15); }}
details {{ margin-top:1rem; color:var(--text-secondary); }}
table {{ border-collapse:collapse; font-size:12.5px; margin-top:.5rem; }}
td,th {{ border:1px solid var(--grid); padding:.25rem .55rem; text-align:right; }}
th:first-child, td:first-child {{ text-align:left; }}
{legend_css}
</style></head>
<body><div class="viz-root">
<h1>{_html.escape(title)}</h1>
<div id="legend"></div>
<svg id="chart" width="920" height="430" role="img" aria-label="Stacked relative abundance per sample"></svg>
<div id="tooltip"></div>
<details><summary>Data table (all taxa)</summary><div id="table"></div></details>
<script>
const D = {payload};
const dark = matchMedia('(prefers-color-scheme: dark)').matches;
const col = s => dark ? s.cd : s.cl;
const svg = document.getElementById('chart');
const NS = 'http://www.w3.org/2000/svg';
const M = {{l:56, r:16, t:10, b:60}};
const W = 920 - M.l - M.r, H = 430 - M.t - M.b;
const n = D.samples.length;
const bw = Math.min(72, W/Math.max(n,1)*0.62);
const step = W/Math.max(n,1);
const totals = D.samples.map((_,i)=>D.series.reduce((a,s)=>a+s.values[i],0));
const ymax = Math.max(1e-9, ...totals);
function el(t,a){{const e=document.createElementNS(NS,t);for(const k in a)e.setAttribute(k,a[k]);return e;}}
// grid + y axis
for (let g=0; g<=4; g++) {{
  const y = M.t + H - H*g/4;
  svg.appendChild(el('line',{{x1:M.l,x2:M.l+W,y1:y,y2:y,stroke:'var(--grid)','stroke-width':1}}));
  const t=el('text',{{x:M.l-8,y:y+4,'text-anchor':'end'}});
  t.textContent=(ymax*g/4).toPrecision(2); svg.appendChild(t);
}}
const tip = document.getElementById('tooltip');
D.samples.forEach((smp,i)=>{{
  let y0 = M.t + H;
  const x = M.l + step*i + (step-bw)/2;
  D.series.forEach(s=>{{
    const v = s.values[i]; if (v<=0) return;
    const h = H*v/ymax;
    const r = el('rect',{{x:x, y:y0-h, width:bw, height:Math.max(h-2,0.8), rx:3,
      fill:col(s)}});
    r.addEventListener('mousemove',ev=>{{tip.style.opacity=1;
      tip.style.left=(ev.clientX+12)+'px'; tip.style.top=(ev.clientY-10)+'px';
      tip.innerHTML='<b>'+s.name+'</b><br>'+smp+': '+v.toPrecision(4);}});
    r.addEventListener('mouseleave',()=>tip.style.opacity=0);
    svg.appendChild(r);
    y0 -= h;
  }});
  const t=el('text',{{x:x+bw/2,y:M.t+H+18,'text-anchor':'middle'}});
  t.textContent=smp.length>14?smp.slice(0,13)+'…':smp; svg.appendChild(t);
}});
const leg = document.getElementById('legend');
D.series.forEach(s=>{{
  const sp=document.createElement('span');
  const i=document.createElement('i'); i.style.background=col(s);
  sp.appendChild(i); sp.appendChild(document.createTextNode(s.name));
  leg.appendChild(sp);
}});
const tb=document.getElementById('table');
let htmlT='<table><tr><th>tax unit</th>'+D.samples.map(s=>'<th>'+s+'</th>').join('')+'</tr>';
D.rows.forEach(r=>{{htmlT+='<tr><td>'+r[0]+'</td>'+r.slice(1).map(v=>'<td>'+Number(v).toPrecision(4)+'</td>').join('')+'</tr>';}});
tb.innerHTML=htmlT+'</table>';
</script>
</div></body></html>
"""
