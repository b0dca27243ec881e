// Tiny SVG chart helpers for the per-operator metric panels (reference
// webui uses chart components over /metrics; same data, hand-rolled SVG).

// ring-buffered time series per key, fed by successive metric polls
export class SeriesStore {
  constructor(cap = 60) { this.cap = cap; this.series = new Map(); }
  push(key, value) {
    if (!this.series.has(key)) this.series.set(key, []);
    const s = this.series.get(key);
    s.push(Number(value) || 0);
    if (s.length > this.cap) s.shift();
  }
  get(key) { return this.series.get(key) || []; }
}

export function sparkline(points, w = 120, h = 26) {
  if (!points.length) return `<svg width="${w}" height="${h}"></svg>`;
  const max = Math.max(...points, 1e-9);
  const step = points.length > 1 ? w / (points.length - 1) : w;
  const xy = points.map((v, i) =>
    `${(i * step).toFixed(1)},${(h - 2 - (v / max) * (h - 6)).toFixed(1)}`);
  const line = `M${xy.join(" L")}`;
  const fill = `${line} L${w},${h} L0,${h} Z`;
  return `<svg width="${w}" height="${h}">
    <path class="sparkfill" d="${fill}"/>
    <path class="spark" d="${line}"/></svg>`;
}

export function backpressureBar(frac) {
  const pct = Math.round(Math.min(Math.max(frac ?? 0, 0), 1) * 100);
  return `<div class="bp-bar ${pct > 70 ? "hot" : ""}" title="${pct}%">
    <i style="width:${pct}%"></i></div>`;
}
