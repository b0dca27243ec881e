// SPA shell: hash router + shared API helper (reference webui App.tsx /
// react-router; same surface, no build step).
import { jobsView } from "/webui/jobs.js";
import { pipelinesView } from "/webui/pipelines.js";
import { connectionsView } from "/webui/connections.js";
import { udfsView } from "/webui/udfs.js";

export async function api(method, path, body) {
  const r = await fetch(path, {
    method,
    headers: { "Content-Type": "application/json" },
    body: body ? JSON.stringify(body) : undefined,
  });
  const j = await r.json();
  if (!r.ok) throw new Error(j.error || r.statusText);
  return j;
}

export const el = (html) => {
  const t = document.createElement("template");
  t.innerHTML = html.trim();
  return t.content.firstChild;
};

export const esc = (s) => String(s ?? "").replace(/[&<>"']/g,
  (c) => ({ "&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;", "'": "&#39;" }[c]));

const VIEWS = {
  jobs: jobsView,
  pipelines: pipelinesView,
  connections: connectionsView,
  udfs: udfsView,
};

let teardown = null;
let routeSeq = 0;

async function route() {
  const hash = location.hash || "#/jobs";
  const [, view, arg] = hash.split("/");
  const fn = VIEWS[view] || jobsView;
  document.querySelectorAll("#nav a").forEach((a) =>
    a.classList.toggle("active", a.dataset.view === (VIEWS[view] ? view : "jobs")));
  if (teardown) { teardown(); teardown = null; }
  const mount = document.getElementById("view");
  mount.innerHTML = "";
  const seq = ++routeSeq;
  const t = await fn(mount, arg);
  if (seq === routeSeq) {
    teardown = t;       // still the active view
  } else if (t) {
    t();                // superseded while mounting: tear down immediately
  }
}

window.addEventListener("hashchange", route);
route();
