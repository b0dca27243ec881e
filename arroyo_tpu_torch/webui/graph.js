// Dataflow DAG renderer (reference PipelineGraph.tsx, which uses reactflow;
// here a layered longest-path layout drawn as plain SVG).
import { esc } from "/webui/app.js";

export function renderGraph(g, metricsByOp = {}) {
  // longest-path layering: column = max(parent column) + 1
  const depth = {};
  for (const n of g.nodes) depth[n.id] = 0;
  let changed = true;
  let guard = 0;
  while (changed && guard++ < 100) {
    changed = false;
    for (const e of g.edges) {
      if (depth[e.dst] < depth[e.src] + 1) {
        depth[e.dst] = depth[e.src] + 1;
        changed = true;
      }
    }
  }
  const cols = {};
  for (const n of g.nodes) (cols[depth[n.id]] = cols[depth[n.id]] || []).push(n);
  const W = 168, H = 46, GX = 60, GY = 18;
  const ncols = Object.keys(cols).length;
  const maxRows = Math.max(...Object.values(cols).map((c) => c.length));
  const width = ncols * (W + GX) + GX / 2;
  const height = Math.max(maxRows * (H + GY) + GY, 120);
  const pos = {};
  for (const [c, nodes] of Object.entries(cols)) {
    const x = Number(c) * (W + GX) + GX / 2;
    const total = nodes.length * (H + GY) - GY;
    nodes.forEach((n, i) => {
      pos[n.id] = { x, y: (height - total) / 2 + i * (H + GY) };
    });
  }
  const parts = [];
  for (const e of g.edges) {
    const a = pos[e.src], b = pos[e.dst];
    if (!a || !b) continue;
    const x1 = a.x + W, y1 = a.y + H / 2, x2 = b.x, y2 = b.y + H / 2;
    const mx = (x1 + x2) / 2;
    parts.push(`<path class="gedge ${e.type === "shuffle" ? "shuffle" : ""}"
      d="M${x1},${y1} C${mx},${y1} ${mx},${y2} ${x2},${y2}"/>`);
  }
  for (const n of g.nodes) {
    const p = pos[n.id];
    const kind = n.op === "source" ? "source" : n.op === "sink" ? "sink" : "";
    const m = metricsByOp[n.id];
    const sub = m && m.messages_per_sec != null
      ? `${m.messages_per_sec}/s` : `p=${n.parallelism}`;
    const label = esc((n.description || n.op).slice(0, 24));
    parts.push(`<g class="gnode ${kind}" transform="translate(${p.x},${p.y})">
      <rect width="${W}" height="${H}" rx="6"/>
      <text x="9" y="19">${esc(n.op)}</text>
      <text x="9" y="35" class="gsub">${label} · ${esc(sub)}</text>
    </g>`);
  }
  return `<svg class="graph" viewBox="0 0 ${width} ${height}"
    style="max-height:${Math.min(height + 20, 420)}px">
    <defs><marker id="arrow" viewBox="0 0 8 8" refX="7" refY="4"
      markerWidth="7" markerHeight="7" orient="auto">
      <path d="M0,0 L8,4 L0,8 z" fill="#8b96a5"/></marker></defs>
    ${parts.join("\n")}</svg>`;
}
